"""Checkpoints of training: step directories with keep-K and auto-resume,
the port of ``nhans_tpu/train/checkpoint.py``.

The port writes what the JAX package writes (``compat/orbax.py``), so
either package restores the other's checkpoints:

* ``save_variables`` (``load_denoiser``, ``tools/ckpt_average``,
  ``tools/ckpt_npz unpack``): an Orbax variables directory, the tree
  ``{"batch_stats": ..., "params": ...}`` of float32 arrays under the
  flax names (conv kernels HWIO);
* ``Checkpointer.save``: ``<checkpoint_dir>/<model_name>/<step>/`` with
  ``_CHECKPOINT_METADATA`` and the JAX ``TrainState`` under ``default/``:
  ``step`` (int32), ``params``, ``batch_stats`` and ``opt_state``, the
  optax state of the run's ``--alg``, lr schedule and ``--mom``
  (``OPTAX_CHAINS``), its counts int32.

Both are written under a temporary name that neither package takes for
a checkpoint and renamed, so a reader never sees half of one.  They
hold full tensors: a tensor-parallel run joins its model-axis blocks
before it saves, and ``load_into`` cuts them again for a model whose
wide kernels hold blocks (``parallel/sharding_rules.py``), so a
checkpoint loads on any mesh.

The readers (``load``, ``load_variables``, ``checkpoint_keys``) take
those directories, the JAX package's, a run root (``<checkpoint_dir>``
or ``<checkpoint_dir>/<model_name>``: the latest step), and the ``.npz``
forms earlier versions of the port wrote: a flat ``.npz``, a variables
directory holding ``variables.npz``, and a step directory holding
``variables.npz`` and ``train_state.npz`` (the step, the optimizer's
name and update count, and each slot as ``opt/<slot>/<flax path>``).
Steps of both forms count alike (``list_steps``): in a root holding both,
the latest step wins.  An Orbax train state's optax tree maps onto the
port's optimizer slots by ``OPTAX_SLOTS``.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nhans_tpu_torch.compat import orbax
from nhans_tpu_torch.compat.weights import from_flax, to_flax
from nhans_tpu_torch.parallel.sharding_rules import cut_full, model_shards
from nhans_tpu_torch.train.optim import make_schedule

VARIABLES = "variables.npz"
TRAIN_STATE = "train_state.npz"
# what marks a directory as Orbax's: a step directory nests its tree
# under default/, which counts only where it holds the tree's _METADATA
_ORBAX_MARKERS = (orbax.CHECKPOINT_METADATA, orbax.MANIFEST, orbax.METADATA,
                  os.path.join("default", orbax.METADATA))
# optax's state under ``opt_state`` for each --alg (optax 0.2.6, chained
# as nhans_tpu/train/optim.py chains it): the fields of each state of the
# chain, () for an EmptyState.  LR stands for the learning-rate state,
# ScaleByScheduleState(count) where lr is a schedule (--lr_schedule
# cosine with --lr_decay_steps) and else an EmptyState; MOM for
# rmsprop's momentum, TraceState(trace) with a nonzero --mom and else an
# EmptyState.  A ``count`` is the update count; every other field holds
# one array per parameter and is the port's optimizer slot of its name.
LR, MOM = "lr", "mom"
OPTAX_CHAINS = {
    "sgd": ((), LR),
    "momentum": (("trace",), LR),
    "rmsprop": (("nu",), LR, MOM),
    "adadelta": ((), ("e_g", "e_x"), LR),
    "adagrad": (("sum_of_squares",), LR),
    "adam": (("count", "mu", "nu"), LR),
}


def optax_chain(alg: str, scheduled: bool = False, mom: float = 0.0
                ) -> Tuple[Tuple[str, ...], ...]:
    """The fields of each state of optax's chain for ``alg``, with lr a
    schedule or not and rmsprop's ``mom``."""
    alg = alg.lower()
    if alg not in OPTAX_CHAINS:
        raise ValueError(f"unknown optimizer --alg={alg!r}")
    sub = {LR: ("count",) if scheduled else (),
           MOM: ("trace",) if mom else ()}
    return tuple(sub.get(fields, fields) for fields in OPTAX_CHAINS[alg])


# {"<chain index>/<field>": the port's slot} of every chain of an --alg
OPTAX_SLOTS = {
    alg: {f"{i}/{field}": field for scheduled in (False, True)
          for mom in (0.0, 1.0)
          for i, fields in enumerate(optax_chain(alg, scheduled, mom))
          for field in fields if field != "count"}
    for alg in OPTAX_CHAINS}


def _tree_order(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``flat`` in the order a tree of nested dicts flattens (each
    level's keys sorted)."""
    return {k: flat[k] for k in sorted(flat, key=lambda k: k.split("/"))}


def orbax_train_state(state, chain) -> Dict[str, Optional[np.ndarray]]:
    """The JAX ``TrainState`` tree of the port's ``TrainState``, flat in
    its flatten order (``orbax.write``): ``step``, ``params``,
    ``batch_stats`` and ``opt_state`` laid out as ``chain``
    (``optax_chain``); a slot the chain lacks or misses raises
    ``ValueError``."""
    opt = state.opt_state
    fields = {f for c in chain for f in c if f != "count"}
    if fields != set(opt) - {"count"}:
        raise ValueError(f"the optimizer slots {sorted(opt)} do not fit "
                         f"the optax chain {chain}")
    count = np.int32(opt["count"])
    flat = {"step": np.int32(state.step),
            **_tree_order(to_flax(state.params, "params")),
            **_tree_order(to_flax(state.batch_stats, "batch_stats"))}
    for i, chained in enumerate(chain):
        if not chained:
            flat[f"opt_state/{i}"] = None
        for field in chained:
            if field == "count":
                flat[f"opt_state/{i}/count"] = count
            else:
                flat.update(_tree_order(to_flax(
                    opt[field], f"opt_state/{i}/{field}")))
    return flat


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


def _is_step(path: str) -> bool:
    return (orbax.is_checkpoint(os.path.join(path, "default"))
            or os.path.exists(os.path.join(path, TRAIN_STATE)))


def list_steps(path: str):
    """The complete step directories under ``path``, in order: Orbax
    steps (the port's and the JAX package's) and the ``.npz`` steps of
    earlier versions of the port."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path) if d.isdigit()
                  and _is_step(os.path.join(path, d)))


def resolve(path: str) -> str:
    """A step directory from a user's path: the directory itself, or the
    latest step (of either form) under a ``<checkpoint_dir>`` or
    ``<checkpoint_dir>/<name>`` root with a single model."""
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


def _replace(tmp: str, final: str) -> None:
    """Move the finished ``tmp`` to ``final``, in place of what was
    there."""
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


def save_variables(directory: str, variables: Dict[str, np.ndarray]) -> str:
    """Write flat flax variables (``params/...``, ``batch_stats/...``) as
    the Orbax variables directory ``directory``, as the JAX package's
    ``save_variables`` does (in place of what was there); returns its
    path."""
    started = time.time_ns()
    final = os.path.abspath(directory)
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    orbax.write(tmp, _tree_order(variables))
    orbax.write_checkpoint_metadata(tmp, step=False, init_ns=started)
    _replace(tmp, final)
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
    """The ``params/...`` and ``batch_stats/...`` of an Orbax tree (read
    from ``tree`` unless its arrays ``flat`` are given), floats as
    float32."""
    if flat is None:
        flat = orbax.read(tree, keep=("params", "batch_stats"))
    return {k: v.astype(np.float32, copy=False) if v.dtype.kind == "f"
            else v for k, v in flat.items()
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
    newest ``max_to_keep``, find and restore the latest.  ``alg``,
    ``scheduled`` (lr is a schedule) and ``mom`` are the run's: they fix
    the optax tree a step holds (``optax_chain``)."""

    def __init__(self, directory: str, max_to_keep: int = 1_000_000,
                 name: str = "nhans", alg: str = "sgd",
                 scheduled: bool = False, mom: float = 0.0):
        self.path = os.path.abspath(os.path.join(directory, name))
        os.makedirs(self.path, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.alg = alg.lower()
        self.chain = optax_chain(alg, scheduled, mom)

    def save(self, step: int, state) -> str:
        started = time.time_ns()
        final = os.path.join(self.path, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        orbax.write(os.path.join(tmp, "default"),
                    orbax_train_state(state, self.chain),
                    sequences=("opt_state",))
        orbax.write_checkpoint_metadata(tmp, step=True, init_ns=started)
        _replace(tmp, final)
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
        variables, extra = load(os.path.join(self.path, str(step)),
                                alg=self.alg)
        return step, variables, extra


def make_checkpointer(train) -> Checkpointer:
    """The ``Checkpointer`` of a run's ``TrainConfig``."""
    scheduled = callable(make_schedule(train.lr, train.lr_schedule,
                                       train.lr_decay_steps,
                                       train.lr_min_frac))
    return Checkpointer(train.checkpoint_dir, train.checkpoints_to_keep,
                        train.model_name, train.alg, scheduled, train.mom)


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
