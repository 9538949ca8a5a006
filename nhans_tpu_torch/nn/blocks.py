"""Layers with the JAX package's semantics (``nhans_tpu/nn/blocks.py``).

Parameter names follow the flax modules (``w``, ``b``, ``beta``,
``gamma``, ``pop_mean``, ``pop_variance``) so that a flax checkpoint maps
onto them name for name (``compat/weights.py``).  Convolutions run NCHW
with OIHW weights; ``Dense`` keeps flax's ``[in, out]`` weight.
``BatchNorm`` follows the module's ``training`` flag: batch moments and
the population EMA in training, the population statistics otherwise.

Each layer takes a compute ``dtype`` (float32 or bfloat16) and casts where
the flax layers do: ``Dense`` and ``Conv`` cast their input and their
float32 weight and bias to it, ``BatchNorm`` takes its moments and
normalises in float32 and returns ``dtype``.  Parameters and population
statistics stay float32, so gradients and optimizer state do too.

Under a mesh (``parallel/sharding_rules.py::shard_model``) a
``BatchNorm`` in training takes its moments over the data group's whole
batch, and a wide ``Conv`` or ``Dense`` holds only its model index's block
of output channels and gathers the rest from the model group.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, s: int) -> Tuple[int, int, int]:
    """TF-SAME (low, high) padding and output size for a length-``n`` axis
    under kernel ``k`` and stride ``s``; the odd pad goes on the high side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2, out


class _SumGradOverModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group, where each rank holds the part that reached the input
    through its own block of output channels."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.to(torch.float32).contiguous()
        dist.all_reduce(out, group=ctx.group)
        return out.to(g.dtype), None


class _GatherChannels(torch.autograd.Function):
    """The full output from each model rank's block along ``dim``: each
    rank writes its block into zeros of the full width and the group sums
    them, which is exact (gloo and NCCL both take an all-reduce of CUDA
    tensors; gloo has no all-gather for them).  Every model rank computes
    the same loss from the full output, so the backward takes this rank's
    block of the gradient as it is: a sum over the group would count it
    once per rank."""

    @staticmethod
    def forward(ctx, y, dim, start, full, group):
        ctx.dim, ctx.start, ctx.size = dim, start, y.shape[dim]
        shape = list(y.shape)
        shape[dim] = full
        out = y.new_zeros(shape, dtype=torch.float32)
        out.narrow(dim, start, ctx.size).copy_(y)
        dist.all_reduce(out, group=group)
        return out.to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.start, ctx.size).contiguous(),
                None, None, None, None)


class _ModelShard:
    """A layer's block of output channels on the model axis: rows
    ``[start, start + size)`` of ``full`` along the weight's dim
    ``dim``, gathered over ``group``."""

    def __init__(self, dim: int, start: int, size: int, full: int, group):
        self.dim, self.start, self.size = dim, start, size
        self.full, self.group = full, group


def _shard_weight(layer: nn.Module, dim: int, index: int, count: int,
                  group) -> None:
    """Keep block ``index`` of ``count`` of ``layer.w`` along ``dim``."""
    full = layer.w.shape[dim]
    size = full // count
    with torch.no_grad():
        block = layer.w.narrow(dim, index * size, size).clone()
    layer.w = nn.Parameter(block)
    layer.shard = _ModelShard(dim, index * size, size, full, group)


def _sharded(layer: nn.Module, x: torch.Tensor, apply, out_dim: int,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``apply(x)`` on this rank's block of output channels, gathered to
    all of them along ``out_dim``, plus the bias."""
    sh = layer.shard
    x = _SumGradOverModel.apply(x, sh.group)
    y = _GatherChannels.apply(apply(x), out_dim, sh.start, sh.full, sh.group)
    if bias is None:
        return y
    shape = [1] * y.ndim
    shape[out_dim] = -1
    return y + bias.view(shape)


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` laid out [in, out].  ``w_std`` and
    ``b_init`` are what ``models.init_variables`` fills them with."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 w_std: float = 0.01, b_init: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_std, self.b_init = w_std, b_init
        self.dtype = dtype
        self.w = nn.Parameter(torch.zeros(in_features, features))
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.shard: Optional[_ModelShard] = None

    def shard_out(self, index: int, count: int, group) -> None:
        """Hold block ``index`` of ``count`` of the output features."""
        _shard_weight(self, 1, index, count, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.w.to(self.dtype)
        b = self.b.to(self.dtype) if self.b is not None else None
        if self.shard is not None:
            return _sharded(self, x, lambda v: torch.matmul(v, w), -1, b)
        y = torch.matmul(x, w)
        return y + b if b is not None else y


class Conv(nn.Module):
    """2-D convolution (+bias) on NCHW input with TF padding: ``"SAME"``
    pads each axis explicitly as TF does (PyTorch's ``padding='same'``
    refuses strides above 1 and pads symmetrically), ``"VALID"`` pads
    nothing."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding: str = "SAME", use_bias: bool = True,
                 w_std: float = 0.01, b_init: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_std, self.b_init = w_std, b_init
        self.dtype = dtype
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.w = nn.Parameter(torch.zeros(features, in_features,
                                          *self.kernel_size))
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.shard: Optional[_ModelShard] = None

    def shard_out(self, index: int, count: int, group) -> None:
        """Hold block ``index`` of ``count`` of the output channels."""
        _shard_weight(self, 0, index, count, group)

    def pads(self, x: torch.Tensor,
             freq_size: Optional[int] = None) -> Tuple[int, int, int, int]:
        """The (left, right, top, bottom) zeros ``forward`` pads ``x`` with,
        in F.pad's order: TF-SAME's, or none for VALID.  ``freq_size``: the
        true width of a lane-padded frequency axis; SAME then pads it as TF
        would pad that width (its low pad depends on the size), so that the
        output grid is the native one."""
        if self.padding != "SAME":
            return 0, 0, 0, 0
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        tl, th, _ = same_pads(x.shape[2], kh, sh)
        fl, fh, _ = same_pads(freq_size or x.shape[3], kw, sw)
        return fl, fh, tl, th

    def forward(self, x: torch.Tensor,
                freq_size: Optional[int] = None) -> torch.Tensor:
        """``freq_size``: as ``pads`` takes it."""
        dt = self.dtype
        x = x.to(dt)
        pads = self.pads(x, freq_size)
        if any(pads):
            x = F.pad(x, pads)
        b = None if self.b is None else self.b.to(dt)
        w = self.w.to(dt)
        if self.shard is not None:
            return _sharded(self, x, lambda v: F.conv2d(
                v, w, stride=self.strides), 1, b)
        return F.conv2d(x, w, b, stride=self.strides)


def trunc_normal_(w: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` as TF's ``truncated_normal_initializer(std)``: standard
    normal draws, those beyond two sigma drawn again, then scaled by
    ``std`` with no variance correction; zeros when ``std`` is 0.  Draws
    on the generator's device."""
    with torch.no_grad():
        if std == 0.0:
            return w.zero_()
        u = torch.randn(w.numel(), generator=generator,
                        device=generator.device)
        out = (u.abs() > 2.0).nonzero().flatten()
        while out.numel():
            u[out] = torch.randn(out.numel(), generator=generator,
                                 device=generator.device)
            out = out[u[out].abs() > 2.0]
        return w.copy_(u.view(w.shape) * std)


def trunc_normal(std: float):
    """An initializer ``(shape, generator, device=None) -> Tensor`` that
    draws as ``trunc_normal_``, the counterpart of the flax initializer
    ``nhans_tpu/nn/blocks.py::trunc_normal``."""

    def init(shape, generator: torch.Generator, device=None) -> torch.Tensor:
        return trunc_normal_(torch.empty(shape, device=device), std,
                             generator)

    return init


class BatchNorm(nn.Module):
    """Batch norm over dim 1 (channels of NCHW, features of [N, C]), eps
    1e-3: ``(x - mean) * rsqrt(var + eps) * gamma + beta``.

    In training the moments are the batch's, biased, ``E[x^2] - mean^2``
    in float32 over every dim but the channel, and gradients flow through
    them; each forward then moves the population statistics,
    ``pop = decay * pop + (1 - decay) * batch``, from the detached
    moments.  ``torch.nn.BatchNorm2d`` keeps the unbiased variance there
    and cannot stand in.  Otherwise (the default, as flax's
    ``train=False``) the population statistics are used.  The
    normalisation is in float32 and the output in ``dtype``.
    ``update_stats`` False (``frozen_stats``) keeps the population
    statistics where they are in training.

    With a data ``group`` (``parallel/sharding_rules.py::shard_model``),
    the training moments are those of the group's whole batch, as the JAX
    package's pjit step takes them: each rank's sum and sum of squares go
    through a differentiable all-reduce, whose backward all-reduces the
    upstream gradient, and are divided by the global count.
    ``nn.SyncBatchNorm`` cannot stand in (unbiased variance, another
    momentum rule)."""

    def __init__(self, features: int, eps: float = 1e-3,
                 decay: float = 0.95, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.decay = decay
        self.dtype = dtype
        self.update_stats = True
        self.group = None
        self.beta = nn.Parameter(torch.zeros(features))
        self.gamma = nn.Parameter(torch.ones(features))
        self.register_buffer("pop_mean", torch.zeros(features))
        self.register_buffer("pop_variance", torch.ones(features))
        self.train(False)  # inference unless put in training

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.ndim - 2)
        x32 = x.to(torch.float32)
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            if self.group is None:
                mean = torch.mean(x32, dim=dims)
                var = torch.mean(x32 * x32, dim=dims) - mean * mean
            else:
                mean, var = self._global_moments(x32, dims)
            if self.update_stats:
                with torch.no_grad():
                    d = self.decay
                    self.pop_mean.mul_(d).add_((1 - d) * mean.detach())
                    self.pop_variance.mul_(d).add_((1 - d) * var.detach())
        else:
            mean, var = self.pop_mean, self.pop_variance
        inv = torch.rsqrt(var + self.eps) * self.gamma
        y = (x32 - mean.view(shape)) * inv.view(shape) + self.beta.view(shape)
        return y.to(self.dtype)

    def eval_affine(self):
        """(mean, inv, beta) of the inference map ``(x - mean) * inv +
        beta``, float32 [features]: the population statistics and ``inv``
        computed by the expression the forward uses."""
        inv = torch.rsqrt(self.pop_variance + self.eps) * self.gamma
        return self.pop_mean, inv, self.beta

    def _global_moments(self, x32: torch.Tensor, dims):
        from torch.distributed.nn.functional import all_reduce

        sums = all_reduce(torch.stack([torch.sum(x32, dim=dims),
                                       torch.sum(x32 * x32, dim=dims)]),
                          group=self.group)
        count = (x32.numel() // x32.shape[1]) * dist.get_world_size(
            self.group)
        mean = sums[0] / count
        return mean, sums[1] / count - mean * mean


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Every ``BatchNorm`` under ``module`` leaves its population
    statistics alone while inside: a block recomputed for the backward
    pass must not move them a second time, as flax's ``remat`` keeps the
    first forward's update only."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [bn.update_stats for bn in bns]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn, flag in zip(bns, saved):
            bn.update_stats = flag


def reverse_gradient(x: torch.Tensor, gradient_factor) -> torch.Tensor:
    """-g*x + detach((g+1)*x): the identity forward, the gradient scaled
    by -g (the reference's gradient-reversal trick)."""
    return (-gradient_factor * x
            + ((gradient_factor + 1) * x).detach())
