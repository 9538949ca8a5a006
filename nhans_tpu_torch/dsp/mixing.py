"""SNR mixing, the port of ``nhans_tpu/dsp/mixing.py``.

Every function takes padded waveform buffers of one length L with
per-example valid lengths, so that a batch keeps a fixed shape; every
reduction is masked to the valid region.  Lengths and SNRs may be Python
numbers or tensors broadcastable against the batch.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

_EPS = 1e-6  # peak normalisation: x / (max |x| + 1e-6)


def _as(value, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype or like.dtype, device=like.device)


def _mask(x: torch.Tensor, length) -> torch.Tensor:
    """[..., L] validity mask from per-example lengths."""
    ar = torch.arange(x.shape[-1], device=x.device)
    return (ar < _as(length, x, torch.int64)[..., None]).to(x.dtype)


def peak_normalize(x: torch.Tensor, length, peak=None) -> torch.Tensor:
    """x / (max |x| + 1e-6) over the valid region; ``peak`` supplies a
    whole-file peak computed on the host instead."""
    m = _mask(x, length)
    if peak is None:
        peak = torch.amax(torch.abs(x) * m, dim=-1, keepdim=True)
    else:
        peak = _as(peak, x)[..., None]
    return x * m / (peak + _EPS)


def loop_or_trim(noise: torch.Tensor, noise_len, target_len) -> torch.Tensor:
    """Repeat (or cut) the noise cyclically to ``target_len`` inside the
    buffer; zero beyond ``target_len``."""
    ar = torch.arange(noise.shape[-1], device=noise.device)
    nlen = torch.clamp(_as(noise_len, noise, torch.int64), min=1)
    idx = torch.remainder(ar, nlen[..., None])
    if noise.ndim > 1:
        out = torch.gather(noise, -1, idx.expand(noise.shape))
    else:
        out = noise[idx]
    return out * _mask(out, target_len)


def _power(x: torch.Tensor, length) -> torch.Tensor:
    """mean(x^2) over the valid region."""
    m = _mask(x, length)
    n = torch.clamp(_as(length, x), min=1.0)
    return torch.sum(x * x * m, dim=-1) / n


def mixing_gains(psignal: torch.Tensor, pnoise: torch.Tensor,
                 snr_db) -> torch.Tensor:
    """K = sqrt(Psig / Pnoise * 10^(-snr / 10)); K = 1 where Pnoise == 0."""
    snr_db = _as(snr_db, psignal)
    silent = pnoise == 0
    k = torch.sqrt(psignal / torch.where(silent, torch.ones_like(pnoise),
                                         pnoise)
                   * torch.pow(10.0, -snr_db / 10.0))
    return torch.where(silent, torch.ones_like(k), k)


def mix_two_noise(clean: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                  clean_len, pos_len, neg_len, snr_pos, snr_neg
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Denoiser mixing of peak-normalised inputs, the clean one trimmed to
    whole frames.  Returns (mixed, target, pos_scaled, neg_scaled), each
    divided by the mixture's peak, the target (clean + positive noise)
    included."""
    nse_pos = loop_or_trim(pos, pos_len, clean_len)
    nse_neg = loop_or_trim(neg, neg_len, clean_len)
    psig = _power(clean, clean_len)
    k_pos = mixing_gains(psig, _power(nse_pos, clean_len), snr_pos)
    k_neg = mixing_gains(psig, _power(nse_neg, clean_len), snr_neg)
    pos_scaled = k_pos[..., None] * nse_pos
    neg_scaled = k_neg[..., None] * nse_neg
    clean = clean * _mask(clean, clean_len)
    mixed = clean + pos_scaled + neg_scaled
    peak = torch.amax(torch.abs(mixed), dim=-1, keepdim=True) + _EPS
    target = (clean + pos_scaled) / peak
    return mixed / peak, target, pos_scaled / peak, neg_scaled / peak


def mix_one_noise(clean: torch.Tensor, noise: torch.Tensor, clean_len,
                  noise_len, snr) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor, torch.Tensor]:
    """Separator mixing.  Returns (clean, noise * K, mixed / peak(mixed),
    K): only the mixture is normalised by its own peak, and K lets the
    caller scale the interference at its full length for its context."""
    nse = loop_or_trim(noise, noise_len, clean_len)
    psig = _power(clean, clean_len)
    k = mixing_gains(psig, _power(nse, clean_len), snr)
    noise_scaled = k[..., None] * nse
    clean = clean * _mask(clean, clean_len)
    mixed = clean + noise_scaled
    peak = torch.amax(torch.abs(mixed), dim=-1, keepdim=True) + _EPS
    return clean, noise_scaled, mixed / peak, k


def snr_index_from_path(path, num_snrs: int, prefix_hex: int = 8) -> int:
    """Evaluation SNR index: the md5 of the clean path, its first
    ``prefix_hex`` hex digits mod ``num_snrs`` (8 for the positive noise,
    6 for the negative one)."""
    if isinstance(path, str):
        path = path.encode("utf-8")
    return int(hashlib.md5(path).hexdigest()[:prefix_hex], 16) % num_snrs
