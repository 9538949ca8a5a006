"""Checkpoints of training: step directories with keep-K and auto-resume,
the port of ``nhans_tpu/train/checkpoint.py``.

The port writes its own form: ``<checkpoint_dir>/<model_name>/<step>/``
holds

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

The readers (``load``, ``load_variables``, ``checkpoint_keys``) also take
the Orbax directories the JAX package writes (``compat/orbax.py``): a
``save_variables`` directory, a ``Checkpointer`` step directory
(``<step>/default``) and its run root (``<checkpoint_dir>`` or
``<checkpoint_dir>/<model_name>``: the latest step).  They give the same
flat dicts as the port's own form; a train state's optax tree is mapped
onto the port's optimizer slots by ``OPTAX_SLOTS``.  Auto-resume and the
writers stay on the port's own form.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nhans_tpu_torch.compat import orbax
from nhans_tpu_torch.compat.weights import from_flax, to_flax
from nhans_tpu_torch.parallel.sharding_rules import cut_full, model_shards

VARIABLES = "variables.npz"
TRAIN_STATE = "train_state.npz"
# what marks a directory as Orbax's: a step directory nests its tree
# under default/, which counts only where it holds the tree's _METADATA
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt", orbax.METADATA,
                  os.path.join("default", orbax.METADATA))
# optax's state tree under ``opt_state`` for each --alg (optax 0.2.6 as
# nhans_tpu/train/optim.py chains it): {"<chain index>/<field>": the
# port's slot}.  Empty nodes (EmptyState) hold nothing; a ``count`` field
# (adam's, or a schedule's) is the update count, which without one is
# the step.
OPTAX_SLOTS = {
    "sgd": {},
    "momentum": {"0/trace": "trace"},
    "rmsprop": {"0/nu": "nu", "2/trace": "trace"},
    "adadelta": {"1/e_g": "e_g", "1/e_x": "e_x"},
    "adagrad": {"0/sum_of_squares": "sum_of_squares"},
    "adam": {"0/mu": "mu", "0/nu": "nu"},
}


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


def _is_step(path: str, orbax_steps: bool) -> bool:
    return os.path.exists(os.path.join(path, TRAIN_STATE)) or (
        orbax_steps and orbax.is_checkpoint(os.path.join(path, "default")))


def list_steps(path: str, orbax_steps: bool = False):
    """The complete step directories under ``path``, in order: the port's
    own, and with ``orbax_steps`` the JAX package's Orbax steps too."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path) if d.isdigit()
                  and _is_step(os.path.join(path, d), orbax_steps))


def resolve(path: str) -> str:
    """A step directory from a user's path: the directory itself, or the
    latest step (of either form) under a ``<checkpoint_dir>`` or
    ``<checkpoint_dir>/<name>`` root with a single model."""
    path = os.path.abspath(path)
    for _ in range(2):
        if os.path.exists(os.path.join(path, VARIABLES)) or is_orbax(path):
            return path
        steps = list_steps(path, orbax_steps=True)
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


def _locate(path: str) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """(the Orbax tree directory, or None; the ``.npz`` of the
    variables and the ``train_state.npz``, or None) of a checkpoint in
    any form: a flat ``.npz``, a variables directory, a step directory
    or a run root (``resolve``), of the port or of the JAX package's
    Orbax (whose step directories nest the tree under ``default/``)."""
    if path.endswith(".npz") and os.path.isfile(path):
        return None, path, None
    step_dir = resolve(path)
    if is_orbax(step_dir):
        nested = os.path.join(step_dir, "default")
        return (nested if orbax.is_checkpoint(nested) else step_dir,
                None, None)
    variables = os.path.join(step_dir, VARIABLES)
    if not os.path.exists(variables):
        raise FileNotFoundError(f"no checkpoint at {path}")
    state = os.path.join(step_dir, TRAIN_STATE)
    return None, variables, (state if os.path.exists(state) else None)


def _read(npz: str) -> Dict[str, np.ndarray]:
    with np.load(npz) as z:
        return {k: z[k] for k in z.files}


def _read_orbax_variables(tree: str, flat=None) -> Dict[str, np.ndarray]:
    """The float32 ``params/...`` and ``batch_stats/...`` of an Orbax
    tree (read from ``tree`` unless its arrays ``flat`` are given)."""
    if flat is None:
        flat = orbax.read(tree, keep=("params", "batch_stats"))
    return {k: v.astype(np.float32, copy=False) for k, v in flat.items()
            if k.split("/", 1)[0] in ("params", "batch_stats")}


def _train_state_from_optax(flat: Dict[str, np.ndarray], alg: str,
                           where: str = "checkpoint") -> dict:
    """The flat ``train_state`` dict (``step``, ``alg``, ``opt/count``,
    ``opt/<slot>/<flax path>``) of an Orbax train state's arrays
    ``flat``, its optax tree mapped by ``OPTAX_SLOTS[alg]``; a field the
    mapping lacks raises ``ValueError`` naming it and ``alg``."""
    alg = alg.lower()
    if alg not in OPTAX_SLOTS:
        raise ValueError(f"unknown optimizer --alg={alg!r}")
    slots = OPTAX_SLOTS[alg]
    extra = {"step": np.int64(flat["step"]), "alg": np.array(alg)}
    counts = set()
    for key, value in flat.items():
        if not key.startswith("opt_state/"):
            continue
        index, _, rest = key[len("opt_state/"):].partition("/")
        if rest == "count":
            counts.add(int(value))
            continue
        field, _, param = rest.partition("/")
        slot = slots.get(f"{index}/{field}")
        if slot is None:
            raise ValueError(
                f"{where}: its optimizer state opt_state/{index}/{field} "
                f"does not fit --alg {alg}, whose optax state holds "
                f"{sorted(slots) or 'no arrays'}")
        extra[f"opt/{slot}/{param}"] = value
    if len(counts) > 1:
        raise ValueError(f"{where}: its update counts {sorted(counts)} "
                         "disagree")
    extra["opt/count"] = np.int64(counts.pop() if counts else extra["step"])
    return extra


def load(path: str, alg: Optional[str] = None
         ) -> Tuple[dict, Optional[dict]]:
    """(variables, train_state or None) of a checkpoint in any form
    ``_locate`` takes; a flat ``.npz`` and a variables directory hold
    inference variables only.  An Orbax train state records no
    optimizer, so its optax tree is mapped for ``alg`` (required
    there)."""
    tree, variables, state = _locate(path)
    if tree is None:
        return _read(variables), (_read(state) if state else None)
    if not {"opt_state", "step"} <= orbax.top_level_keys(tree):
        return _read_orbax_variables(tree), None
    if alg is None:
        raise ValueError(f"{path} is an Orbax train state, which records "
                         "no optimizer: pass the run's --alg")
    flat = orbax.read(tree)
    return (_read_orbax_variables(tree, flat),
            _train_state_from_optax(flat, alg, tree))


def load_variables(path: str) -> Dict[str, np.ndarray]:
    """The flat inference variables (``params/...``, ``batch_stats/...``)
    of a checkpoint in any form ``load`` takes, without its train
    state."""
    tree, variables, _ = _locate(path)
    return _read(variables) if tree is None else _read_orbax_variables(tree)


def checkpoint_keys(path: str) -> frozenset:
    """The top-level keys of a checkpoint (any form ``load`` takes), read
    without loading an array (an Orbax tree's from its ``_METADATA``): a
    full train state carries ``opt_state`` and ``step``, inference
    variables only ``params`` and ``batch_stats``."""
    tree, variables, state = _locate(path)
    if tree is not None:
        return orbax.top_level_keys(tree)
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
