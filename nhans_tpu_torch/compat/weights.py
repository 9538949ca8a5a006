"""Load the JAX package's flat ``.npz`` weights into the port's modules.

The ``.npz`` holds flax variables flattened with ``/``: float16
``params/...`` and float32 ``batch_stats/...`` (the format of
``tools/ckpt_npz.py``).  The port's modules carry the flax names, so a key
maps to a ``state_dict`` key by dropping the collection and reading ``/``
as ``.``.  Conv kernels go from HWIO to OIHW; dense ``[in, out]`` weights
are kept as they are; population statistics become buffers.  ``to_flax``
is the way back, for checkpoints.  ``cut_shard`` and ``join_shards`` cut a
full tensor into the model axis's blocks and join them again
(``parallel/sharding_rules.py``), so that a tensor-parallel run starts
from the JAX package's weights and its checkpoints hold full tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats")


def from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables -> a float32 ``state_dict`` for ``NHANSNet``."""
    state = {}
    for key, value in flat.items():
        coll, _, path = key.partition("/")
        if coll not in _COLLECTIONS or not path:
            raise KeyError(f"unexpected checkpoint key {key!r}")
        arr = np.array(value, np.float32)  # a writable copy
        if arr.ndim == 4:  # conv kernel HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        name = path.replace("/", ".")
        if name in state:
            raise KeyError(f"checkpoint key {key!r} maps onto {name!r} twice")
        state[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def to_flax(tensors: Dict[str, torch.Tensor],
            collection: str) -> Dict[str, np.ndarray]:
    """Tensors keyed by ``state_dict`` name -> flat float32 flax arrays
    ``<collection>/<path>`` (copies), conv kernels back from OIHW to
    HWIO."""
    flat = {}
    for name, value in tensors.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        if arr.ndim == 4:  # conv kernel OIHW -> HWIO
            arr = arr.transpose(2, 3, 1, 0)
        # a copy: a CPU tensor's numpy() shares its storage
        flat[f"{collection}/{name.replace('.', '/')}"] = np.array(arr,
                                                                  order="C")
    return flat


def flat_variables(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Flat flax variables of an ``NHANSNet`` ``state_dict``: its
    population statistics under ``batch_stats/``, the rest under
    ``params/``; ``from_flax``'s inverse."""
    stats = {k for k in state if k.endswith(("pop_mean", "pop_variance"))}
    return {**to_flax({k: v for k, v in state.items() if k not in stats},
                      "params"),
            **to_flax({k: v for k, v in state.items() if k in stats},
                      "batch_stats")}


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """``from_flax`` of a flat ``.npz`` checkpoint."""
    with np.load(path) as z:
        return from_flax({k: z[k] for k in z.files})


def cut_shard(t: torch.Tensor, dim: int, index: int,
              count: int) -> torch.Tensor:
    """Block ``index`` of ``count`` equal blocks of ``t`` along ``dim``
    (a copy): a model-axis shard of a full tensor."""
    if t.shape[dim] % count:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {count} blocks")
    size = t.shape[dim] // count
    return t.narrow(dim, index * size, size).clone()


def join_shards(blocks, dim: int) -> torch.Tensor:
    """The full tensor of the model-axis blocks ``blocks`` (in model
    index order) along ``dim``; ``cut_shard``'s inverse."""
    return torch.cat(list(blocks), dim=dim)
