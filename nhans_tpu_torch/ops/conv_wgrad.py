"""The towers' k x k convolutions' weight and bias gradients in float32:
the CUDA kernel, its plain version and the wrapper that chooses between
them by device.

For y = conv2d(pad(x, pads), w, b, stride) and its output gradient dy,
``conv_wgrad(x, dy, kernel, stride, pads, bias)`` returns dw (w's shape)
and, with ``bias``, db = dy summed over all but the channel axis.  The
kernel (``csrc/conv_wgrad.cu``) sums the products of dy and the unpadded
x over the N x Ho x Wo positions in float32 multiply-adds, reading the
pads as zeros, in slices that a second launch adds in order: no atomics,
so that the result is the same bit for bit from run to run.  A gradient
of more than 32 columns (Cin x kh x kw) takes 32 positions a step on a
128 x 128 tile (64 x 256 for a kernel 4 wide and at most 64 output
channels); one of at most 32 (one input channel) takes 128 positions a
step on a 64 x 16 or 64 x 32 tile.  ``tile`` gives the tile and
``wgrad_slices`` the slices, both from the shapes alone.  The plain
version is the same sum written with ``F.unfold``.

A CPU tensor goes to the plain version and a CUDA tensor to the kernel;
the wrapper never falls back from one to the other.
``conv_wgrad.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nhans_tpu_torch.ops import _build

# the (kh, kw) the kernel is built for, as csrc/tower_conv.cu's forward
KERNEL_SHAPES = ((3, 3), (4, 4), (8, 4))
STEP = 32                  # positions a step of the kernel's sum
NARROW_COLS = 32           # at most this many columns: the narrow kernel,
NARROW_STEP = 128          # its positions a step
MIN_STEPS = 8              # steps a slice at least
SMS = 132                  # an H100's SMs: the slices fill whole waves
WORKSPACE_BYTES = 64 * 2 ** 20


def tile(cout: int, cin: int, kernel: Sequence[int]) -> Tuple[int, int, int]:
    """The kernel's (BM, BN) block tile and positions a step for ``cout``
    output and ``cin`` input channels and a (kh, kw) ``kernel``."""
    kh, kw = kernel
    cols = cin * kh * kw
    if cols <= NARROW_COLS:
        return 64, (16 if cols <= 16 else 32), NARROW_STEP
    return (64, 256, STEP) if kw == 4 and cout <= 64 else (128, 128, STEP)


@functools.lru_cache(maxsize=None)
def wgrad_slices(cout: int, cin: int, kernel: Tuple[int, int],
                 positions: int) -> Tuple[int, int]:
    """(slices, positions a slice) of the sum over ``positions`` for the
    gradient of a (cout, cin, *kernel) weight: the fewest slices whose
    blocks fill waves of ``SMS`` within 2 % as well as the best count
    allowed, with at least ``MIN_STEPS`` steps a slice and the slices'
    partial sums (beyond one) under ``WORKSPACE_BYTES``."""
    bm, bn, step = tile(cout, cin, kernel)
    cols = cin * kernel[0] * kernel[1]
    tiles = -(-cout // bm) * -(-cols // bn)
    most = max(1, min((WORKSPACE_BYTES - 1) // (4 * (cout * cols + cout)),
                      positions // (step * MIN_STEPS)))

    def filled(s):
        return tiles * s / (-(-tiles * s // SMS) * SMS)

    best = max(filled(s) for s in range(1, most + 1))
    s = next(s for s in range(1, most + 1) if filled(s) >= best - 0.02)
    per = -(-positions // s)                  # a slice's share, rounded up
    per = -(-per // step) * step              # to whole steps
    return -(-positions // per), per


def conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                     kernel: Sequence[int], stride: Sequence[int],
                     pads: Tuple[int, int, int, int], bias: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dw, db or None): the columns of ``pad(x, pads)`` (``pads`` in
    F.pad's order, left, right, top, bottom) against dy, summed over the
    images."""
    N, Cout = dy.shape[:2]
    cols = F.unfold(F.pad(x, tuple(pads)) if any(pads) else x,
                    tuple(kernel), stride=tuple(stride))
    dw = torch.bmm(dy.reshape(N, Cout, -1), cols.transpose(1, 2)).sum(0)
    db = dy.sum((0, 2, 3)) if bias else None
    return dw.reshape(Cout, x.shape[1], *kernel), db


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib, _ = _build.load("conv_wgrad")
    fn = lib.nhans_conv_wgrad
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv_wgrad(x: torch.Tensor, dy: torch.Tensor, kernel: Sequence[int],
               stride: Sequence[int], pads: Tuple[int, int, int, int],
               bias: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dw [Cout, Cin, kh, kw], db [Cout] or None) of conv2d(pad(x, pads),
    w, b, stride) from x [N, Cin, H, W] and dy [N, Cout, Ho, Wo], float32
    and contiguous on one device; ``kernel`` (kh, kw) one of
    ``KERNEL_SHAPES``, ``pads`` (left, right, top, bottom) as F.pad takes
    them."""
    for name, t in (("x", x), ("dy", dy)):
        if t.dtype != torch.float32 or t.ndim != 4:
            raise ValueError(f"conv_wgrad: {name} must be a 4-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"conv_wgrad: {name} is not contiguous")
    if dy.device != x.device:
        raise ValueError(f"conv_wgrad: dy is on {dy.device}, x on {x.device}")
    N, Cin, H, W = x.shape
    Cout, Ho, Wo = dy.shape[1:]
    kh, kw = kernel
    sh, sw = stride
    pl, pr, pt, pb = pads
    if (tuple(kernel) not in KERNEL_SHAPES or min(sh, sw) < 1
            or min(pads) < 0 or dy.shape[0] != N
            or (Ho, Wo) != ((H + pt + pb - kh) // sh + 1,
                            (W + pl + pr - kw) // sw + 1)):
        raise ValueError(f"conv_wgrad: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, kernel {tuple(kernel)}, stride "
                         f"{tuple(stride)}, pads {tuple(pads)}: not a "
                         "convolution the kernel takes")
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, dy, kernel, stride, pads, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no conv_wgrad kernel for device {x.device}")
    K, cols = N * Ho * Wo, Cin * kh * kw
    if (min(N, Ho, Wo) < 1 or max(K, x.numel(), dy.numel()) >= 2 ** 30
            or Cin * H * W >= 2 ** 26):
        raise ValueError(f"conv_wgrad: shape {tuple(x.shape)} -> "
                         f"{tuple(dy.shape)} is beyond the kernel")
    S, per = wgrad_slices(Cout, Cin, (kh, kw), K)
    dw = torch.empty((Cout, Cin, kh, kw), dtype=x.dtype, device=x.device)
    db = torch.empty(Cout, dtype=x.dtype, device=x.device) if bias else None
    ws = (torch.empty(S * (Cout * cols + Cout), dtype=x.dtype,
                      device=x.device) if S > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                           None if db is None else db.data_ptr(),
                           None if ws is None else ws.data_ptr(),
                           N, Cin, H, W, Cout, Ho, Wo, kh, kw, sh, sw, pt, pl,
                           S, per, stream)
    if err != 0:
        raise RuntimeError(f"conv_wgrad kernel launch failed: cudaError {err}")
    conv_wgrad.launches += 1
    return dw, db


conv_wgrad.launches = 0
