"""Spectra and waveforms for the reference, in float64.

TF's ``tf.signal`` conventions, as N-HANS uses them: a periodic Hann
window, frames of ``frame_length`` every ``frame_step`` samples with the
ragged tail dropped, the rDFT of each windowed frame, ``log(|X| + eps)``;
the inverse is the irDFT of each frame times TF's dual synthesis window
(the Hann window over the periodic sum of the overlapping squared
windows), overlapped and added.  Float64 throughout, so that bins near
zero come out right; the callers cast to float32 where the network
begins.
"""

from __future__ import annotations

import math

import torch


def num_frames(n: int, frame_length: int, frame_step: int) -> int:
    return 0 if n < frame_length else 1 + (n - frame_length) // frame_step


def hann(length: int, device) -> torch.Tensor:
    k = torch.arange(length, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / length)


def rdft(x: torch.Tensor, frame_length: int, frame_step: int) -> torch.Tensor:
    """Complex spectra [..., F, bins] of signals [..., L] (float64)."""
    f = num_frames(x.shape[-1], frame_length, frame_step)
    frames = x.to(torch.float64)[..., :(f - 1) * frame_step + frame_length]
    frames = frames.unfold(-1, frame_length, frame_step)
    return torch.fft.rfft(frames * hann(frame_length, x.device), dim=-1)


def log_magnitude(spec: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.log(spec.abs() + eps)


def synthesis_window(frame_length: int, frame_step: int, device):
    w = hann(frame_length, device)
    overlaps = -(-frame_length // frame_step)
    sq = torch.nn.functional.pad(w * w, (0, overlaps * frame_step
                                         - frame_length))
    denom = sq.reshape(overlaps, frame_step).sum(0).repeat(overlaps)
    return w / denom[:frame_length]


def istft(spec: torch.Tensor, frame_length: int, frame_step: int):
    """Signal [T] of complex spectra [F, bins]: irDFT, synthesis window,
    overlap-add; T = frame_step * (F - 1) + frame_length."""
    frames = torch.fft.irfft(spec, n=frame_length, dim=-1)
    frames = frames * synthesis_window(frame_length, frame_step, spec.device)
    nf = frames.shape[0]
    out = torch.zeros(frame_step * (nf - 1) + frame_length,
                      dtype=frames.dtype, device=frames.device)
    idx = (torch.arange(nf, device=spec.device)[:, None] * frame_step
           + torch.arange(frame_length, device=spec.device)[None, :])
    out.index_add_(0, idx.reshape(-1), frames.reshape(-1))
    return out
