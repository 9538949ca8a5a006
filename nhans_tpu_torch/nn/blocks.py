"""Layers with the JAX package's semantics (``nhans_tpu/nn/blocks.py``),
for inference.

Parameter names follow the flax modules (``w``, ``b``, ``beta``,
``gamma``, ``pop_mean``, ``pop_variance``) so that a flax checkpoint maps
onto them name for name (``compat/weights.py``).  Convolutions run NCHW
with OIHW weights; ``Dense`` keeps flax's ``[in, out]`` weight.

Training semantics of ``BatchNorm`` (biased batch moments, population EMA)
come with the training slice of the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, s: int) -> Tuple[int, int, int]:
    """TF-SAME (low, high) padding and output size for a length-``n`` axis
    under kernel ``k`` and stride ``s``; the odd pad goes on the high side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2, out


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` laid out [in, out]."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_features, features))
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.w)
        return y + self.b if self.b is not None else y


class Conv(nn.Module):
    """2-D convolution (+bias) on NCHW input with TF padding: ``"SAME"``
    pads each axis explicitly as TF does (PyTorch's ``padding='same'``
    refuses strides above 1 and pads symmetrically), ``"VALID"`` pads
    nothing."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding: str = "SAME", use_bias: bool = True):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.w = nn.Parameter(torch.zeros(features, in_features,
                                          *self.kernel_size))
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            (kh, kw), (sh, sw) = self.kernel_size, self.strides
            tl, th, _ = same_pads(x.shape[2], kh, sh)
            fl, fh, _ = same_pads(x.shape[3], kw, sw)
            if tl or th or fl or fh:
                x = F.pad(x, (fl, fh, tl, th))
        return F.conv2d(x, self.w, self.b, stride=self.strides)


class BatchNorm(nn.Module):
    """Inference batch norm over dim 1 (channels of NCHW, features of
    [N, C]) from the population statistics, eps 1e-3:
    ``(x - pop_mean) * rsqrt(pop_variance + eps) * gamma + beta``."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.beta = nn.Parameter(torch.zeros(features))
        self.gamma = nn.Parameter(torch.ones(features))
        self.register_buffer("pop_mean", torch.zeros(features))
        self.register_buffer("pop_variance", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.pop_variance + self.eps) * self.gamma
        return ((x - self.pop_mean.view(shape)) * inv.view(shape)
                + self.beta.view(shape))

