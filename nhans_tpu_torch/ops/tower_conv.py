"""The towers' k x k convolutions in float32: the CUDA kernel, its plain
version, the wrapper that chooses between them by device, and the
training convolution that runs its forward and backward on the kernels.

In inference a ``CondResBlock`` (``nn/model.py``) runs ``conv1`` (stride
1 or 2, no bias) and ``conv2`` (stride 1, with bias), each as
``Conv.forward`` computes it: TF-SAME pads by ``F.pad``, then
``F.conv2d``.  The kernel (``csrc/tower_conv.cu``) computes the same
direct sum in float32 multiply-adds, reading the pads as zeros and adding
the bias as it stores, so that neither the padded copy nor the bias add
exists; its outputs differ from cuDNN's float32 ones only by the order of
the sum.  The plain version is ``Conv.forward``'s arithmetic.

``tower_conv(x, w, b, stride, pads)`` checks its inputs, then sends a CPU
tensor to the plain version and a CUDA tensor to the kernel; it never
falls back from one to the other.  ``tower_conv.launches`` counts the
kernel's launches.

``TrainConv`` is the same convolution with grad on: its forward is
``tower_conv``; its backward takes the input gradient of a stride-1
convolution as ``tower_conv`` of the output gradient with the weights
rotated by 180 degrees and the pads mirrored (``input_grad``), that of a
strided one from cuDNN, and the weight and bias gradients from
``ops.conv_wgrad``.  It saves the unpadded input.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nhans_tpu_torch.ops import _build
# the (kh, kw) both kernels are built for: the main tower's and the context
# tower's
from nhans_tpu_torch.ops.conv_wgrad import KERNEL_SHAPES, conv_wgrad


def out_size(n: int, k: int, s: int, lo: int, hi: int) -> int:
    """F.conv2d's output length along an axis of ``n`` padded by
    (``lo``, ``hi``)."""
    return (n + lo + hi - k) // s + 1


def tower_conv_plain(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], stride: Sequence[int],
                     pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """``F.conv2d(F.pad(x, pads), w, b, stride)``: ``pads`` in F.pad's
    order (left, right, top, bottom), as ``Conv.forward`` pads."""
    if any(pads):
        x = F.pad(x, tuple(pads))
    return F.conv2d(x, w, b, stride=tuple(stride))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib, _ = _build.load("tower_conv")
    fn = lib.nhans_tower_conv
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tower_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               stride: Sequence[int],
               pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """``conv2d(pad(x, pads), w, b, stride)`` for x [N, Cin, H, W] and w
    [Cout, Cin, kh, kw] ((kh, kw) one of ``KERNEL_SHAPES``), b [Cout] or
    None, all float32 and contiguous on one device; ``pads`` (left, right,
    top, bottom) as F.pad takes them."""
    tensors = [("x", x, 4), ("w", w, 4)] + ([] if b is None else
                                            [("b", b, 1)])
    for name, t, ndim in tensors:
        if t.dtype != torch.float32 or t.ndim != ndim:
            raise ValueError(f"tower_conv: {name} must be a {ndim}-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"tower_conv: {name} is not contiguous")
        if t.device != x.device:
            raise ValueError(f"tower_conv: {name} is on {t.device}, x on "
                             f"{x.device}")
    N, Cin, H, W = x.shape
    Cout, wc, kh, kw = w.shape
    sh, sw = stride
    pl, pr, pt, pb = pads
    if (wc != Cin or (kh, kw) not in KERNEL_SHAPES
            or (b is not None and b.shape[0] != Cout)
            or min(sh, sw) < 1 or min(pads) < 0):
        raise ValueError(f"tower_conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}, stride "
                         f"{tuple(stride)}, pads {tuple(pads)}: not a "
                         "convolution the kernel takes")
    if x.device.type == "cpu":
        return tower_conv_plain(x, w, b, stride, pads)
    if x.device.type != "cuda":
        raise ValueError(f"no tower_conv kernel for device {x.device}")
    Ho, Wo = out_size(H, kh, sh, pt, pb), out_size(W, kw, sw, pl, pr)
    if min(N, Ho, Wo) < 1 or max(x.numel(), N * Cout * Ho * Wo) >= 2 ** 62:
        raise ValueError(f"tower_conv: shape {tuple(x.shape)} -> "
                         f"({Ho}, {Wo}) is beyond the kernel")
    # [Cin * k * k, Cout] with zero columns up to a multiple of 4
    wt = F.pad(w.reshape(Cout, -1).t(), (0, -Cout % 4)).contiguous()
    out = torch.empty((N, Cout, Ho, Wo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(x.data_ptr(), wt.data_ptr(),
                           None if b is None else b.data_ptr(),
                           out.data_ptr(), N, Cin, H, W, Cout, wt.shape[1],
                           Ho, Wo, kh, kw, sh, sw, pt, pl, stream)
    if err != 0:
        raise RuntimeError(f"tower_conv kernel launch failed: cudaError {err}")
    tower_conv.launches += 1
    return out


tower_conv.launches = 0


def input_grad(dy: torch.Tensor, w: torch.Tensor,
               x_shape: Sequence[int], stride: Sequence[int],
               pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """dx of y = conv2d(pad(x, pads), w, stride) from dy (contiguous).  At
    stride 1 (pads within the kernel), dx is the convolution of dy padded
    by (k - 1 - lo, k - 1 - hi) on each axis with w rotated by 180 degrees
    and transposed to [Cin, Cout, kh, kw], through ``tower_conv``; else
    cuDNN's input gradient on the padded geometry, cropped."""
    kh, kw = w.shape[2:]
    pl, pr, pt, pb = pads
    if tuple(stride) == (1, 1) and max(pl, pr) < kw and max(pt, pb) < kh:
        w_rot = w.flip((2, 3)).transpose(0, 1).contiguous()
        return tower_conv(dy, w_rot, None, (1, 1),
                          (kw - 1 - pl, kw - 1 - pr, kh - 1 - pt, kh - 1 - pb))
    N, Cin, H, W = x_shape
    padded = dy.new_empty(1).expand(N, Cin, H + pt + pb, W + pl + pr)
    dx = torch.ops.aten.convolution_backward(
        dy, padded, w, None, tuple(stride), (0, 0), (1, 1), False, (0, 0), 1,
        (True, False, False))[0]
    return dx[:, :, pt:pt + H, pl:pl + W]


class TrainConv(torch.autograd.Function):
    """``tower_conv(x, w, b, stride, pads)`` with its backward on the
    kernels: dx by ``input_grad`` (where x needs it), dw and db by
    ``conv_wgrad``.  x, w and b as ``tower_conv`` takes them."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pads):
        x = x.contiguous()
        ctx.stride, ctx.pads = tuple(stride), tuple(pads)
        ctx.save_for_backward(x, w)
        return tower_conv(x, w, b, stride, pads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x:
            dx = input_grad(dy, w, x.shape, ctx.stride, ctx.pads)
        if need_w or need_b:
            dw, db = conv_wgrad(x, dy, w.shape[2:], ctx.stride, ctx.pads,
                                need_b)
        return dx, dw if need_w else None, db, None, None
