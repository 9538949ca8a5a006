"""Checkpoints of training: step directories with keep-K and auto-resume,
the port of ``nhans_tpu/train/checkpoint.py``.

The JAX package writes Orbax directories, which the port cannot read.
The port writes its own: ``<checkpoint_dir>/<model_name>/<step>/`` holds

* ``variables.npz``: the flat float32 ``params/...`` and
  ``batch_stats/...`` arrays under the flax names, conv kernels HWIO, the
  layout ``compat/weights.py::load_npz`` reads (so serving takes a step
  directory's ``variables.npz`` as its ``--checkpoint``);
* ``train_state.npz``: the step, the optimizer's name and update count,
  and each of its state slots as ``opt/<slot>/<flax path>``.

A step directory is written under a temporary name and renamed, so a
reader never sees half of one.  A variables directory
(``save_variables``: ``load_denoiser``, ``tools/ckpt_average``,
``tools/ckpt_npz unpack``) holds only ``variables.npz``, itself written
under a temporary name and renamed; it stands where the JAX package
writes an Orbax directory.  Both files hold full tensors: a
tensor-parallel run joins its model-axis blocks before it saves, and
``load_into`` cuts them again for a model whose wide kernels hold blocks
(``parallel/sharding_rules.py``), so a checkpoint loads on any mesh.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nhans_tpu_torch.compat.weights import from_flax, to_flax
from nhans_tpu_torch.parallel.sharding_rules import cut_full, model_shards

VARIABLES = "variables.npz"
TRAIN_STATE = "train_state.npz"
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt", "_METADATA",
                  "default")


def flat_train_state(state, alg: str) -> Tuple[dict, dict]:
    """(variables, train_state) flat numpy dicts of a ``TrainState``."""
    variables = {**to_flax(state.params, "params"),
                 **to_flax(state.batch_stats, "batch_stats")}
    extra = {"step": np.int64(state.step), "alg": np.array(alg),
             "opt/count": np.int64(state.opt_state["count"])}
    for slot, tensors in state.opt_state.items():
        if slot != "count":
            extra.update(to_flax(tensors, f"opt/{slot}"))
    return variables, extra


def opt_state_from_flat(extra: dict, device) -> dict:
    """The optimizer state of a flat ``train_state`` dict."""
    slots: Dict[str, dict] = {}
    for key, value in extra.items():
        if key.startswith("opt/") and key != "opt/count":
            _, slot, path = key.split("/", 2)
            slots.setdefault(slot, {})[f"params/{path}"] = value
    opt = {"count": int(extra["opt/count"])}
    for slot, flat in slots.items():
        opt[slot] = {k: v.to(device) for k, v in from_flax(flat).items()}
    return opt


def is_orbax(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS)


def list_steps(path: str):
    """The complete step directories under ``path``, in order."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path) if d.isdigit()
                  and os.path.exists(os.path.join(path, d, TRAIN_STATE)))


def resolve(path: str) -> str:
    """A step directory from a user's path: the directory itself, or the
    latest step under a ``<checkpoint_dir>`` or ``<checkpoint_dir>/<name>``
    root with a single model."""
    path = os.path.abspath(path)
    for _ in range(2):
        if os.path.exists(os.path.join(path, VARIABLES)) or is_orbax(path):
            return path
        steps = list_steps(path)
        if steps:
            return os.path.join(path, str(steps[-1]))
        subs = [d for d in os.listdir(path)
                if os.path.isdir(os.path.join(path, d))] \
            if os.path.isdir(path) else []
        if len(subs) != 1:
            break
        path = os.path.join(path, subs[0])
    return path


def save_variables(directory: str, variables: Dict[str, np.ndarray]) -> str:
    """Write flat flax variables as ``<directory>/variables.npz`` (the
    directory made if need be), under a temporary name and renamed;
    returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, VARIABLES)
    tmp = os.path.join(directory, f"variables.tmp-{os.getpid()}.npz")
    np.savez(tmp, **variables)
    os.replace(tmp, final)
    return final


def _archives(path: str) -> Tuple[str, Optional[str]]:
    """(the ``.npz`` of a checkpoint's variables, its ``train_state.npz``
    or None) for a flat ``.npz``, a variables directory, a step directory
    or a run root (``resolve``).  An Orbax directory of the JAX package is
    refused: export it as a flat ``.npz`` with the JAX package's
    ``tools/ckpt_npz.py pack`` first."""
    if path.endswith(".npz") and os.path.isfile(path):
        return path, None
    step_dir = resolve(path)
    if is_orbax(step_dir):
        raise ValueError(
            f"{path} is an Orbax checkpoint of the JAX package, which "
            "nhans_tpu_torch cannot read; export its variables on a "
            f"machine with JAX with `python tools/ckpt_npz.py pack {path} "
            "<out.npz>` and pass the .npz")
    variables = os.path.join(step_dir, VARIABLES)
    if not os.path.exists(variables):
        raise FileNotFoundError(f"no checkpoint at {path}")
    state = os.path.join(step_dir, TRAIN_STATE)
    return variables, (state if os.path.exists(state) else None)


def _read(npz: str) -> Dict[str, np.ndarray]:
    with np.load(npz) as z:
        return {k: z[k] for k in z.files}


def load(path: str) -> Tuple[dict, Optional[dict]]:
    """(variables, train_state or None) of a checkpoint in any form
    ``_archives`` takes; a flat ``.npz`` holds inference variables
    only."""
    variables, state = _archives(path)
    return _read(variables), (_read(state) if state else None)


def load_variables(path: str) -> Dict[str, np.ndarray]:
    """The flat inference variables (``params/...``, ``batch_stats/...``)
    of a checkpoint in any form ``load`` takes, without its train
    state."""
    return _read(_archives(path)[0])


def checkpoint_keys(path: str) -> frozenset:
    """The top-level keys of a checkpoint (any form ``load`` takes), read
    from the archives' directories without loading an array: a full train
    state carries ``opt_state`` and ``step``, inference variables only
    ``params`` and ``batch_stats``."""
    variables, state = _archives(path)
    with np.load(variables) as z:
        keys = {k.split("/", 1)[0] for k in z.files}
    return frozenset(keys | ({"opt_state", "step"} if state else set()))


class Checkpointer:
    """Step directories under ``<directory>/<name>``: save, keep the
    newest ``max_to_keep``, find and restore the latest."""

    def __init__(self, directory: str, max_to_keep: int = 1_000_000,
                 name: str = "nhans"):
        self.path = os.path.abspath(os.path.join(directory, name))
        os.makedirs(self.path, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, step: int, state, alg: str) -> str:
        variables, extra = flat_train_state(state, alg)
        final = os.path.join(self.path, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, VARIABLES), **variables)
        np.savez(os.path.join(tmp, TRAIN_STATE), **extra)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.path, str(old)))
        return final

    def steps(self):
        return list_steps(self.path)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Tuple[int, dict, dict]:
        """(step, variables, train_state) of ``step`` or the latest."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.path}")
        variables, extra = load(os.path.join(self.path, str(step)))
        return step, variables, extra


def load_into(model: torch.nn.Module, variables: dict) -> None:
    """Copy flat flax variables into ``model`` in place (every name must
    match); a kernel that holds a model-axis block takes its block."""
    state = cut_full(from_flax(variables), model_shards(model))
    missing = set(model.state_dict()) ^ set(state)
    if missing:
        raise ValueError(f"checkpoint does not match the model: "
                         f"{sorted(missing)[:8]}")
    with torch.no_grad():
        for name, tensor in model.state_dict().items():
            src = state[name]
            if src.shape != tensor.shape:
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(src.shape)} != {tuple(tensor.shape)}")
            tensor.copy_(src)
