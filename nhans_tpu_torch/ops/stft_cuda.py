"""Fused waveform -> log-magnitude spectrogram: the CUDA kernel, its plain
PyTorch version, and the wrapper that chooses between them by device.

The kernel (``csrc/log_spectrogram.cu``) replaces the TPU kernel
``nhans_tpu/ops/stft_pallas.py::pallas_log_spectrogram``.  It packs each
windowed 400-sample frame into 200 complex values, takes a 200-point
float32 FFT in shared memory (Stockham stages of radix 5, 5 and 8) and
splits the result into the 201 real bins: about 3 operations per byte
moved, so bytes bound it.  Every twiddle comes from the cos table of
``_tables``; the two real bins, 0 and 200, are summed in float64.  One
block computes 4 frames of one row; its source says what the design does
and why.

``log_spectrogram_kernel(x)`` sends a CPU tensor to the plain version and
a CUDA tensor to the kernel; it never falls back from one to the other.
``log_spectrogram_kernel.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nhans_tpu_torch.dsp import spectral as sp
from nhans_tpu_torch.ops import _build

FRAME_LENGTH = 400
FRAME_STEP = 160
BINS = FRAME_LENGTH // 2 + 1
LOG_EPS = 1e-5
TILE_FRAMES = 4  # frames per block; the grid is B * ceil(F / 4) blocks
_MAX_BLOCKS = 2 ** 31 - 1  # gridDim.x


def log_spectrogram_plain(x: torch.Tensor, with_reim: bool = False):
    """The plain version: framed-matmul DFT of ``dsp.spectral``, then
    ``log(|X| + 1e-5)``.  [B, L] -> [B, F, 201] (x3 with ``with_reim``)."""
    re, im = sp.stft(x, FRAME_LENGTH, FRAME_STEP)
    lm = sp.log_magnitude(re, im, LOG_EPS)
    return (lm, re, im) if with_reim else lm


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """cos(2*pi*m/400) for m in [0, 400) and the periodic Hann window,
    in float32, then the window in float64 (its 3.2 KB as 800 float32
    words): the kernel takes every twiddle from the cos table
    (-sin(2*pi*m/400) = cos(2*pi*(m+100)/400)), windows the FFT's input
    with the float32 window and sums the real bins 0 and 200 with the
    float64 one."""
    m = np.arange(FRAME_LENGTH)
    ang = 2.0 * np.pi * m / FRAME_LENGTH
    win = 0.5 - 0.5 * np.cos(ang)
    tab = np.concatenate([np.cos(ang).astype(np.float32),
                          win.astype(np.float32), win.view(np.float32)])
    return torch.as_tensor(tab, device=device)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib, _ = _build.load("log_spectrogram")
    fn = lib.nhans_log_spectrogram
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def log_spectrogram_kernel(x: torch.Tensor, with_reim: bool = False):
    """[B, L] float32 waveform rows -> [B, F, 201] log-magnitude, with
    F = 1 + (L - 400) // 160 (0 when L < 400); with ``with_reim`` also the
    raw re and im of the windowed rDFT, as (lm, re, im)."""
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("log_spectrogram_kernel takes a contiguous 2-D "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")
    if x.device.type == "cpu":
        return log_spectrogram_plain(x, with_reim)
    if x.device.type != "cuda":
        raise ValueError(f"no spectrogram kernel for device {x.device}")
    B, L = x.shape
    F = sp.num_frames(L, FRAME_LENGTH, FRAME_STEP)
    if L >= 2 ** 31 or B * -(-F // TILE_FRAMES) > _MAX_BLOCKS:
        raise ValueError(f"shape {tuple(x.shape)} is beyond the kernel's grid")
    outs = [torch.empty((B, F, BINS), dtype=torch.float32, device=x.device)
            for _ in range(3 if with_reim else 1)]
    if B and F:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            re_ptr = outs[1].data_ptr() if with_reim else None
            im_ptr = outs[2].data_ptr() if with_reim else None
            err = _kernel_fn()(x.data_ptr(), outs[0].data_ptr(), re_ptr,
                               im_ptr, _tables(x.device).data_ptr(),
                               B, L, F, stream)
        if err != 0:
            raise RuntimeError(f"log_spectrogram kernel launch failed: "
                               f"cudaError {err}")
        log_spectrogram_kernel.launches += 1
    return tuple(outs) if with_reim else outs[0]


log_spectrogram_kernel.launches = 0
