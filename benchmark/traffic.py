"""The general traffic generator: lengths, orders and audio from the seed.

A cell's traffic is a data file (``workloads/<cell>.json``); what it
names is made here.  Lengths are fixed quantiles of a clipped log-normal
distribution, the same set for every seed; the seed draws only their
order and the audio, so two seeds give the same work in another order.
Audio is synthetic, made on the device in a few large calls and brought
to the host as int16-valued float32 arrays: voiced speech (a glottal
pitch with vibrato, 16 falling harmonics, a syllabic envelope and a
breath floor) and coloured noise with a hum, with neither exact silence
nor clipping, so that no bin of a frame sits at zero.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Sequence

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, stream])
                      .generate_state(1, np.uint64)[0] >> 1))
    return g


def quantile_lengths(count: int, median_s: float, sigma: float, lo_s: float,
                     hi_s: float, sample_rate: int) -> np.ndarray:
    """``count`` lengths in samples, ascending: the (i + 1/2) / count
    quantiles of a log-normal distribution of median ``median_s`` and log
    standard deviation ``sigma``, clipped to [lo_s, hi_s] seconds."""
    nd = NormalDist()
    secs = [min(max(median_s * math.exp(sigma * nd.inv_cdf((i + 0.5) / count)),
                    lo_s), hi_s) for i in range(count)]
    return np.asarray([int(round(s * sample_rate)) for s in secs], np.int64)


def name_order_batches(rng: np.random.Generator, count: int, batch: int,
                       deal_seed: int) -> List[List[int]]:
    """Indices into ``count`` ascending lengths split as the command line
    splits a folder: consecutive runs of ``batch`` files in name order.
    The name order is the permutation that ``deal_seed`` draws, the same
    for every seed, so every seed serves the same batches; ``rng`` draws
    the order within each batch."""
    if count % batch:
        raise ValueError("count must split into batches")
    order = np.random.default_rng(deal_seed).permutation(count)
    return [[int(i) for i in rng.permutation(order[s:s + batch])]
            for s in range(0, count, batch)]


def _uniform(g, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def speech(g: torch.Generator, lengths: Sequence[int],
           sample_rate: int) -> List[np.ndarray]:
    """Voiced speech of the given lengths, peak 30 to 60 % of full scale,
    on the host."""
    return host(speech_rows(g, lengths, sample_rate), lengths)


def noise(g: torch.Generator, lengths: Sequence[int],
          sample_rate: int) -> List[np.ndarray]:
    """Coloured noise with a hum, RMS 800 to 3000, on the host."""
    return host(noise_rows(g, lengths, sample_rate), lengths)


def host(rows: torch.Tensor, lengths: Sequence[int]) -> List[np.ndarray]:
    """Each row cut to its length, as float32 arrays on the host."""
    h = rows.cpu().numpy()
    return [h[i, :int(n)].copy() for i, n in enumerate(lengths)]


def speech_rows(g: torch.Generator, lengths: Sequence[int],
                sample_rate: int) -> torch.Tensor:
    """Speech as ``speech`` makes it, one row each on the generator's
    device, zero past each length."""
    n, L = len(lengths), int(max(lengths))
    dev = g.device
    t = torch.arange(L, device=dev, dtype=torch.float32)[None, :] / sample_rate
    f0 = _uniform(g, (n, 1), 90.0, 250.0)
    vib = 1.0 + _uniform(g, (n, 1), 0.02, 0.06) * torch.sin(
        2 * math.pi * _uniform(g, (n, 1), 3.0, 6.0) * t
        + _uniform(g, (n, 1), 0.0, 6.3))
    phase = 2 * math.pi * torch.cumsum(f0 * vib, dim=1) / sample_rate
    tilt = _uniform(g, (n, 1), 0.6, 1.2)
    x = torch.zeros((n, L), device=dev)
    for k in range(1, 17):
        x += torch.sin(k * phase + _uniform(g, (n, 1), 0.0, 6.3)) / k ** tilt
    syl = 0.5 - 0.5 * torch.cos(2 * math.pi * _uniform(g, (n, 1), 3.0, 5.0) * t
                                + _uniform(g, (n, 1), 0.0, 6.3))
    x = x * (0.15 + 0.85 * syl * syl)
    x = x + 0.03 * torch.randn((n, L), generator=g, device=dev)
    return _scaled(x, lengths, _uniform(g, (n, 1), 0.3, 0.6) * 32767.0,
                   peak=True)


def noise_rows(g: torch.Generator, lengths: Sequence[int],
               sample_rate: int) -> torch.Tensor:
    """Noise as ``noise`` makes it, one row each on the generator's
    device, zero past each length."""
    n, L = len(lengths), int(max(lengths))
    dev = g.device
    w = torch.randn((n, L), generator=g, device=dev)
    f = torch.fft.rfftfreq(L, 1.0 / sample_rate).to(dev)[None, :]
    fc = _uniform(g, (n, 1), 300.0, 3000.0)
    x = torch.fft.irfft(torch.fft.rfft(w) / torch.sqrt(1.0 + (f / fc) ** 2),
                        n=L)
    x = x / x.std(dim=1, keepdim=True)
    t = torch.arange(L, device=dev, dtype=torch.float32)[None, :] / sample_rate
    x = x + _uniform(g, (n, 1), 0.0, 1.0) * torch.sin(
        2 * math.pi * _uniform(g, (n, 1), 50.0, 200.0) * t)
    return _scaled(x, lengths, _uniform(g, (n, 1), 800.0, 3000.0),
                   peak=False)


def _scaled(x: torch.Tensor, lengths, scale: torch.Tensor,
            peak: bool) -> torch.Tensor:
    """``x`` cut to each row's length and scaled so that its peak (or its
    RMS) there is ``scale``, in whole int16 steps."""
    keep = (torch.arange(x.shape[1], device=x.device)[None, :]
            < torch.as_tensor(list(lengths), device=x.device)[:, None])
    x = x * keep
    n = keep.sum(dim=1, keepdim=True)
    ref = (x.abs().amax(dim=1, keepdim=True) if peak
           else torch.sqrt((x * x).sum(dim=1, keepdim=True) / n))
    return torch.clamp(torch.round(x / ref * scale), -32767.0, 32767.0)


def snr_mix(rng: np.random.Generator, voice: np.ndarray,
            parts: Sequence[np.ndarray], snrs_db: Sequence[float]
            ) -> np.ndarray:
    """``voice`` plus each noise part (looped from a random offset to the
    voice's length) at an SNR drawn from ``snrs_db``, clipped to int16."""
    out = voice.astype(np.float64)
    pv = float(np.mean(out * out))
    for part in parts:
        start = int(rng.integers(len(part)))
        seg = np.resize(np.roll(part, -start), len(voice)).astype(np.float64)
        snr = float(rng.choice(snrs_db))
        out += seg * math.sqrt(pv / max(float(np.mean(seg * seg)), 1e-9)
                               * 10 ** (-snr / 10))
    return np.clip(np.rint(out), -32767, 32767).astype(np.float32)
