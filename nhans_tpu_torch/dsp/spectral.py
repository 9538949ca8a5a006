"""STFT / iSTFT with TensorFlow ``tf.signal`` semantics, in PyTorch.

The port of ``nhans_tpu/dsp/spectral.py``:

* periodic Hann analysis window,
* frames = 1 + (N - frame_length) // frame_step (no pad_end),
* synthesis window = hann / (periodic sum of squared overlapped hanns),
  the dual window of ``tf.signal.inverse_stft_window_fn``,
* scatter-free overlap-add reconstruction.

The DFTs are products with windowed bases built in float64 and cast to
the working type, as in the JAX package.  ``torch.stft``/``torch.istft``
are not used: their window normalisation is not TF's.

``spectrogram_reim``, ``spectrogram`` and ``log_spectrogram`` are the
serving front end: they go through
``nhans_tpu_torch.ops.stft_cuda.log_spectrogram_kernel``, which launches
the hand-written CUDA kernel for a CUDA tensor and runs the framed-matmul
DFT below for a CPU tensor.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def hann_window(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (``tf.signal.hann_window(periodic=True)``)."""
    n = np.arange(length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)
    return torch.as_tensor(w, dtype=dtype, device=device)


@functools.lru_cache(maxsize=8)
def _synthesis_window_np(frame_length: int, frame_step: int) -> np.ndarray:
    """TF inverse_stft_window_fn: hann / periodic sum of squared windows."""
    n = np.arange(frame_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / frame_length)
    denom = w * w
    overlaps = -(-frame_length // frame_step)  # ceil
    pad = overlaps * frame_step - frame_length
    denom = np.pad(denom, (0, pad))
    denom = denom.reshape(overlaps, frame_step).sum(axis=0)
    denom = np.tile(denom, overlaps)[:frame_length]
    return (w / denom).astype(np.float64)


def synthesis_window(frame_length: int, frame_step: int,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(_synthesis_window_np(frame_length, frame_step),
                           dtype=dtype, device=device)


@functools.lru_cache(maxsize=8)
def _dft_bases_np(frame_length: int,
                  num_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed forward rDFT bases (cos_basis, sin_basis), each
    [frame_length, num_bins], with the Hann window folded in."""
    n = np.arange(frame_length)[:, None]
    k = np.arange(num_bins)[None, :]
    ang = 2.0 * np.pi * n * k / frame_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_length)
                           / frame_length)
    cos_b = np.cos(ang) * w[:, None]
    sin_b = -np.sin(ang) * w[:, None]
    return cos_b.astype(np.float64), sin_b.astype(np.float64)


@functools.lru_cache(maxsize=8)
def _idft_bases_np(frame_length: int,
                   num_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse rDFT bases: x[n] = Re(X) @ C + Im(X) @ S, each
    [num_bins, frame_length], with the 1/N and the conjugate-symmetry
    doubling folded in."""
    k = np.arange(num_bins)[:, None]
    n = np.arange(frame_length)[None, :]
    ang = 2.0 * np.pi * k * n / frame_length
    scale = np.full((num_bins, 1), 2.0 / frame_length)
    scale[0] = 1.0 / frame_length
    if frame_length % 2 == 0:
        scale[-1] = 1.0 / frame_length
    cos_b = np.cos(ang) * scale
    sin_b = -np.sin(ang) * scale
    return cos_b.astype(np.float64), sin_b.astype(np.float64)


def num_frames(num_samples: int, frame_length: int = 400,
               frame_step: int = 160) -> int:
    if num_samples < frame_length:
        return 0
    return 1 + (num_samples - frame_length) // frame_step


def frame_signal(x: torch.Tensor, frame_length: int = 400,
                 frame_step: int = 160) -> torch.Tensor:
    """Slice a signal [..., T] into frames [..., F, frame_length]
    (``tf.signal.frame(pad_end=False)``: the ragged tail is dropped)."""
    f = num_frames(x.shape[-1], frame_length, frame_step)
    if f == 0:
        return x.new_zeros((*x.shape[:-1], 0, frame_length))
    return x[..., :(f - 1) * frame_step + frame_length].unfold(
        -1, frame_length, frame_step)


def stft(x: torch.Tensor, frame_length: int = 400,
         frame_step: int = 160) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward STFT of [..., T] -> (real, imag), each [..., F, bins]
    (``tf.signal.stft(x, frame_length, frame_step, fft_length=frame_length)``)."""
    bins = frame_length // 2 + 1
    frames = frame_signal(x, frame_length, frame_step)
    cos_np, sin_np = _dft_bases_np(frame_length, bins)
    cos_b = torch.as_tensor(cos_np, dtype=x.dtype, device=x.device)
    sin_b = torch.as_tensor(sin_np, dtype=x.dtype, device=x.device)
    return torch.matmul(frames, cos_b), torch.matmul(frames, sin_b)


def log_magnitude(re: torch.Tensor, im: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """log(|X| + eps)."""
    return torch.log(torch.sqrt(re * re + im * im) + eps)


def stft_magphase(x: torch.Tensor, frame_length: int = 400,
                  frame_step: int = 160) -> Tuple[torch.Tensor, torch.Tensor]:
    """(magnitude, phase) of the STFT, from the framed-matmul ``stft``."""
    re, im = stft(x, frame_length, frame_step)
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def _check_geometry(frame_length: int, frame_step: int, eps: float) -> None:
    if (frame_length, frame_step, eps) != (400, 160, 1e-5):
        raise ValueError(
            "the spectrogram kernel is built for frame_length=400, "
            "frame_step=160, eps=1e-5; got "
            f"({frame_length}, {frame_step}, {eps})")


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    if x.ndim not in (1, 2):
        raise ValueError(f"expected a [L] or [B, L] signal, got {tuple(x.shape)}")
    return (x[None] if x.ndim == 1 else x).to(torch.float32).contiguous()


def spectrogram_reim(x: torch.Tensor, frame_length: int = 400,
                     frame_step: int = 160, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(log_magnitude, re, im) of [L] or [B, L].  The mixed-phase
    reconstruction needs only cos/sin of the phase, re/|X| and im/|X|, so
    no arctan2 is taken."""
    from nhans_tpu_torch.ops import stft_cuda

    _check_geometry(frame_length, frame_step, eps)
    lm, re, im = stft_cuda.log_spectrogram_kernel(_as_rows(x), with_reim=True)
    return (lm[0], re[0], im[0]) if x.ndim == 1 else (lm, re, im)


def spectrogram(x: torch.Tensor, frame_length: int = 400,
                frame_step: int = 160, eps: float = 1e-5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_magnitude, phase) of [L] or [B, L], the model's input
    representation: ``spectrogram_reim`` (the CUDA kernel with re/im on a
    card), then arctan2(im, re)."""
    lm, re, im = spectrogram_reim(x, frame_length, frame_step, eps)
    return lm, torch.atan2(im, re)


def log_spectrogram(x: torch.Tensor, frame_length: int = 400,
                    frame_step: int = 160, eps: float = 1e-5) -> torch.Tensor:
    """Log-magnitude only: what the context encoder consumes."""
    from nhans_tpu_torch.ops import stft_cuda

    _check_geometry(frame_length, frame_step, eps)
    lm = stft_cuda.log_spectrogram_kernel(_as_rows(x))
    return lm[0] if x.ndim == 1 else lm


def unit_phase(re: torch.Tensor, im: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the phase of re + i im, as re/|X| and im/|X|, and
    (1, 0) where |X| = 0, which is what cos and sin of arctan2(0, 0) give:
    zero-padded frames have |X| = 0, and a plain division would give NaN
    there, which a zero magnitude does not cancel."""
    mag = torch.sqrt(re * re + im * im)
    inv = 1.0 / torch.clamp(mag, min=1e-30)
    return (torch.where(mag > 0, re * inv, 1.0),
            torch.where(mag > 0, im * inv, 0.0))


def overlap_add(frames: torch.Tensor, frame_step: int = 160) -> torch.Tensor:
    """Overlap-add [..., F, L] -> [..., frame_step*(F-1)+L].

    Scatter-free: pad each frame to whole hops, split it into hop-sized
    chunks, and sum the shifted diagonals with static slices."""
    *lead, f, length = frames.shape
    chunks = -(-length // frame_step)  # ceil
    pad = chunks * frame_step - length
    padded = torch.nn.functional.pad(frames, (0, pad))
    padded = padded.reshape(*lead, f, chunks, frame_step)
    out_hops = f + chunks - 1
    total = frames.new_zeros((*lead, out_hops, frame_step))
    for j in range(chunks):
        # frame p's j-th chunk lands at hop p + j
        total[..., j:j + f, :] += padded[..., :, j, :]
    out = total.reshape(*lead, out_hops * frame_step)
    return out[..., :frame_step * (f - 1) + length]


def istft(re: torch.Tensor, im: torch.Tensor, frame_length: int = 400,
          frame_step: int = 160) -> torch.Tensor:
    """Inverse STFT of (real, imag) [..., F, bins] -> [..., T]
    (``tf.signal.inverse_stft`` with ``inverse_stft_window_fn``)."""
    bins = frame_length // 2 + 1
    cos_np, sin_np = _idft_bases_np(frame_length, bins)
    cos_b = torch.as_tensor(cos_np, dtype=re.dtype, device=re.device)
    sin_b = torch.as_tensor(sin_np, dtype=re.dtype, device=re.device)
    frames = torch.matmul(re, cos_b) + torch.matmul(im, sin_b)
    syn = synthesis_window(frame_length, frame_step, frames.dtype,
                           frames.device)
    return overlap_add(frames * syn, frame_step)


def istft_from_logmag(logmag: torch.Tensor, phase: torch.Tensor,
                      frame_length: int = 400,
                      frame_step: int = 160) -> torch.Tensor:
    """A waveform from (log-magnitude, phase): exp, then re/im, then
    ``istft``; the reference's reconstruction with the mixed phase."""
    mag = torch.exp(logmag)
    return istft(mag * torch.cos(phase), mag * torch.sin(phase),
                 frame_length, frame_step)
