"""Fused waveform -> log-magnitude spectrogram: the CUDA kernel, its plain
PyTorch version, and the wrapper that chooses between them by device.

The kernel (``csrc/log_spectrogram.cu``) replaces the TPU kernel
``nhans_tpu/ops/stft_pallas.py::pallas_log_spectrogram``.  The function's
least time is set by bytes (an FFT needs about 3 operations per byte
moved); the kernel's direct 400-point DFT does 32 times that work, so the
float32 operation rate limits it.  Its source says how the design keeps
the product in true float32 and inside a block's shared memory.

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
_MAX_ROWS = 65535  # gridDim.z


def log_spectrogram_plain(x: torch.Tensor, with_reim: bool = False):
    """The plain version: framed-matmul DFT of ``dsp.spectral``, then
    ``log(|X| + 1e-5)``.  [B, L] -> [B, F, 201] (x3 with ``with_reim``)."""
    re, im = sp.stft(x, FRAME_LENGTH, FRAME_STEP)
    lm = sp.log_magnitude(re, im, LOG_EPS)
    return (lm, re, im) if with_reim else lm


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    """cos(2*pi*m/400) for m in [0, 400), then the periodic Hann window:
    the 3.2 KB from which the kernel rebuilds its DFT basis."""
    m = np.arange(FRAME_LENGTH)
    ang = 2.0 * np.pi * m / FRAME_LENGTH
    tab = np.concatenate([np.cos(ang), 0.5 - 0.5 * np.cos(ang)])
    return torch.as_tensor(tab.astype(np.float32), device=device)


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
    if B > _MAX_ROWS or L >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} is beyond the kernel's grid")
    F = sp.num_frames(L, FRAME_LENGTH, FRAME_STEP)
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
