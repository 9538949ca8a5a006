"""The main tower's epilogue after a convolution: conditioning, BatchNorm,
residual and ReLU in one pass.  The CUDA kernel, its plain version and
the wrapper that chooses between them by device.

In inference a ``CondResBlock`` (``nn/model.py``) follows each of its
convolutions with ``Inject`` (four broadcast adds), an optional residual
add, the BatchNorm's affine map in float32 and a ReLU, and in the
lane-padded geometry multiplies the columns past the true width by 0
(which leaves 0, or NaN where the result is a NaN or an infinity).  The kernel
(``csrc/tower_epilogue.cu``) does all of it in one read and one write of
the activation, with the rounding of the PyTorch operations, so that its
output equals theirs bit for bit; the plain version is those operations,
in the modules' order.

``tower_epilogue(y, ...)`` sends a CPU tensor to the plain version and a
CUDA tensor to the kernel; it never falls back from one to the other.
``tower_epilogue.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from nhans_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tower_epilogue_plain(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         t: torch.Tensor, f: torch.Tensor, mean: torch.Tensor,
                         inv: torch.Tensor, beta: torch.Tensor,
                         residual: Optional[torch.Tensor] = None,
                         valid: int = 0) -> torch.Tensor:
    """The plain version: ``Inject``, the residual add, the eval
    ``BatchNorm`` and the ReLU as the modules compute them, then columns
    ``valid`` and beyond times 0 (``valid`` 0: none)."""
    v = (y + a[:, :, None, None] + b[:, :, None, None]
         + t[None, :, :, None] + f[None, :, None, :])
    if residual is not None:
        v = v + residual
    shape = (-1, 1, 1)
    v = ((v.to(torch.float32) - mean.view(shape)) * inv.view(shape)
         + beta.view(shape)).to(y.dtype)
    v = F.relu(v)
    if valid:
        keep = torch.arange(v.shape[3], device=v.device) < valid
        v = v * keep.to(v.dtype)
    return v


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib, _ = _build.load("tower_epilogue")
    fn = lib.nhans_tower_epilogue
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tower_epilogue(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   t: torch.Tensor, f: torch.Tensor, mean: torch.Tensor,
                   inv: torch.Tensor, beta: torch.Tensor,
                   residual: Optional[torch.Tensor] = None,
                   valid: int = 0) -> torch.Tensor:
    """``relu(BatchNorm(y + a + b + t + f [+ residual]))``, times 0 at
    columns ``valid`` and beyond (``valid`` 0: none), as the modules' mask.  y (and ``residual``)
    [N, C, H, W] float32 or bfloat16; a, b [N, C], t [C, H] and f [C, W] in
    y's dtype; mean, inv (``rsqrt(var + eps) * gamma``) and beta [C]
    float32."""
    if y.dtype not in _DTYPES or y.ndim != 4:
        raise ValueError("tower_epilogue takes a 4-D float32 or bfloat16 "
                         f"tensor, got {y.dtype} {tuple(y.shape)}")
    N, C, H, W = y.shape
    shapes = [(a, (N, C), y.dtype), (b, (N, C), y.dtype),
              (t, (C, H), y.dtype), (f, (C, W), y.dtype),
              (mean, (C,), torch.float32), (inv, (C,), torch.float32),
              (beta, (C,), torch.float32)]
    if residual is not None:
        shapes.append((residual, (N, C, H, W), y.dtype))
    for x, shape, dtype in shapes:
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != y.device:
            raise ValueError(f"tower_epilogue: a table is {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}, expected "
                             f"{dtype} {shape} on {y.device}")
    if y.device.type == "cpu":
        return tower_epilogue_plain(y, a, b, t, f, mean, inv, beta, residual,
                                    valid)
    if y.device.type != "cuda":
        raise ValueError(f"no tower_epilogue kernel for device {y.device}")
    if H * W > 2 ** 31 - 256 or N * C >= 2 ** 31:
        raise ValueError(f"shape {tuple(y.shape)} is beyond the kernel")
    ins = [x.contiguous() for x in (y, residual if residual is not None
                                    else y, a, b, t, f, mean, inv, beta)]
    out = torch.empty_like(ins[0])
    if out.numel():
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernel_fn()(
                _DTYPES[y.dtype], ins[0].data_ptr(),
                ins[1].data_ptr() if residual is not None else None,
                out.data_ptr(), *(x.data_ptr() for x in ins[2:]),
                N, C, H, W, valid or W, stream)
        if err != 0:
            raise RuntimeError(f"tower_epilogue kernel launch failed: "
                               f"cudaError {err}")
        tower_epilogue.launches += 1
    return out


tower_epilogue.launches = 0
