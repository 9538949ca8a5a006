"""Which tensors the ``model`` axis splits, and the model put on a mesh:
the port of ``nhans_tpu/parallel/sharding_rules.py``.

The rule is the JAX package's: a kernel ``w`` of two or more dims whose
output channels number at least ``min_channels`` (256) and divide by the
model axis's size is split along them; everything else (biases,
BatchNorm, the narrow layers) is replicated.  At full width that is the
context tower's last two blocks, the 512-wide main-tower convolutions,
their Inject projections and positional MLPs' last layers, and the
head's convolution.  Optimizer slots follow their parameter.  A
convolution's output channels are its OIHW weight's dim 0, a dense
layer's its ``[in, out]`` weight's dim 1.

``shard_model`` cuts those weights to this rank's block (``Conv`` and
``Dense`` then gather their output over the model group) and gives every
training BatchNorm the data group.  Checkpoints hold full tensors:
``gather_full`` joins the blocks, ``cut_full`` cuts a full tensor to this
rank's block, so a ``model_axis=2`` checkpoint loads on one card and the
other way round.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from nhans_tpu_torch.compat.weights import cut_shard
from nhans_tpu_torch.nn.blocks import BatchNorm, Conv, Dense
from nhans_tpu_torch.nn.model import PositionalMLP
from nhans_tpu_torch.parallel.mesh import Mesh

MIN_CHANNELS = 256


def _out_dim(name: str, shape) -> Optional[int]:
    """The output-channel dim of a kernel ``w`` (conv OIHW: 0; dense
    ``[in, out]``: 1), or None for any other tensor."""
    if name.rsplit(".", 1)[-1] != "w" or len(shape) < 2:
        return None
    return 0 if len(shape) == 4 else len(shape) - 1


def param_sharding_rules(mesh: Mesh, params: Dict[str, torch.Tensor],
                         min_channels: int = MIN_CHANNELS
                         ) -> Dict[str, Optional[int]]:
    """For each tensor (keyed by ``state_dict`` name, full shapes) the dim
    split over the model axis, or None where it is replicated."""
    rules = {}
    for name, t in params.items():
        dim = _out_dim(name, tuple(t.shape))
        if (dim is None or mesh.model == 1 or t.shape[dim] < min_channels
                or t.shape[dim] % mesh.model):
            dim = None
        rules[name] = dim
    return rules


def state_sharding(mesh: Mesh, state, use_model_axis: bool = False,
                   min_channels: int = MIN_CHANNELS) -> dict:
    """The split dims of a full ``TrainState``'s params, batch_stats and
    optimizer slots (every slot as its parameter); all None without the
    model axis."""
    rules = param_sharding_rules(mesh, state.params, min_channels)
    if not use_model_axis:
        rules = dict.fromkeys(rules)
    slots = {slot: {k: rules[k] for k in tensors}
             for slot, tensors in state.opt_state.items() if slot != "count"}
    return {"params": rules, "batch_stats": dict.fromkeys(state.batch_stats),
            "opt_state": slots}


def shard_model(model: torch.nn.Module, mesh: Mesh,
                min_channels: int = MIN_CHANNELS) -> Dict[str, int]:
    """Put ``model`` (full weights, the same on every rank) on ``mesh``:
    the training BatchNorms take the data group's moments, and the
    kernels the rule picks keep this rank's block of output channels.
    The positional MLPs' BatchNorms see the same positions on every rank
    and keep their own moments.  Call it before the optimizer's state is
    made.  Returns the split dims of the cut kernels by name."""
    local = {id(bn) for m in model.modules() if isinstance(m, PositionalMLP)
             for bn in m.modules() if isinstance(bn, BatchNorm)}
    for m in model.modules():
        if isinstance(m, BatchNorm) and id(m) not in local:
            m.group = mesh.data_group
    rules = param_sharding_rules(mesh, dict(model.named_parameters()),
                                 min_channels)
    picked = {k: d for k, d in rules.items() if d is not None}
    for name in picked:
        layer = model.get_submodule(name.rsplit(".", 1)[0])
        layer.shard_out(mesh.model_index, mesh.model, mesh.model_group)
    return picked


def model_shards(model: torch.nn.Module) -> dict:
    """``state_dict`` name -> the shard of every cut kernel of ``model``."""
    return {f"{name}.w": m.shard for name, m in model.named_modules()
            if isinstance(m, (Conv, Dense)) and m.shard is not None}


def gather_full(tensors: Dict[str, torch.Tensor], shards: dict
                ) -> Dict[str, torch.Tensor]:
    """``tensors`` (parameters or optimizer slots by name) with every cut
    one joined to its full shape over the model group: a collective, so
    every rank of the group calls it with the same names."""
    out = dict(tensors)
    for name, sh in shards.items():
        if name not in tensors:
            continue
        t = tensors[name].detach()
        shape = list(t.shape)
        shape[sh.dim] = sh.full
        full = t.new_zeros(shape, dtype=torch.float32)
        full.narrow(sh.dim, sh.start, sh.size).copy_(t)
        dist.all_reduce(full, group=sh.group)
        out[name] = full.to(t.dtype)
    return out


def cut_full(tensors: Dict[str, torch.Tensor], shards: dict
             ) -> Dict[str, torch.Tensor]:
    """Full ``tensors`` cut to this rank's block where ``shards`` names
    them."""
    out = dict(tensors)
    for name, sh in shards.items():
        if name in tensors:
            out[name] = cut_shard(tensors[name], sh.dim, sh.start // sh.size,
                                  sh.full // sh.size)
    return out
