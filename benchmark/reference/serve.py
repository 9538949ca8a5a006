"""One utterance enhanced by the reference, as N-HANS serves it.

The mixture, trimmed to whole frames and divided in float32 by its
whole-file peak (+1e-6), as the configuration states, is zero-padded to
the length it is served on (``pad_to``, its batch's length bucket); each
context is its first 200 frames' worth of samples over its own
whole-file peak, its frames tiled cyclically when it is shorter.  Every valid frame's 35-frame window (zeros past the padded
spectrogram) goes through the main tower with both context embeddings;
the residual, capped at ``recon_residual_cap`` nats, is added to the
frame's log-magnitude, and the masked iSTFT with the mixture's phase gives
the waveform, ``frame_step * (frames - 1) + frame_length`` samples.  The
SNR estimate is the energy of that waveform over the energy of what it
removed from the mixture's own reconstruction.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dsp
from benchmark.reference.model import Net, tower_windows


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a float32 divisor is."""
    return float(np.float32(v))


def _context(net: Net, wav: np.ndarray, device) -> torch.Tensor:
    c = net.cfg
    fl, fs, C = c["frame_length"], c["frame_step"], c["context_frames"]
    ctx_n = (C - 1) * fs + fl
    n = min(len(wav), ctx_n)
    peak = float(np.max(np.abs(wav))) if len(wav) else 0.0
    buf = torch.zeros(ctx_n, dtype=torch.float32, device=device)
    buf[:n] = torch.from_numpy(np.asarray(wav[:n], np.float32)).to(device)
    lm = dsp.log_magnitude(dsp.rdft(buf / _f32(peak + 1e-6), fl, fs),
                           c["log_eps"])
    nf = max(1 + max(n - fl, 0) // fs, 1)
    lm = lm[torch.arange(C, device=device) % nf]
    return net.embed(lm.to(torch.float32)[None])


@torch.no_grad()
def enhance(net: Net, mixed: np.ndarray, ctx_a: np.ndarray,
            ctx_b: np.ndarray, pad_to: int, device) -> dict:
    """{"denoised": float64 [n_out] on the host, "snr_est": float}."""
    c = net.cfg
    fl, fs = c["frame_length"], c["frame_step"]
    peak = float(np.max(np.abs(mixed)))
    n = len(mixed)
    if n >= fl:
        n -= (n - fl) % fs
    x = torch.zeros(max(pad_to, n), dtype=torch.float32, device=device)
    x[:n] = torch.from_numpy(np.asarray(mixed[:n], np.float32)).to(device)
    spec = dsp.rdft(x / _f32(peak + 1e-6), fl, fs)               # [F, bins]
    lm = dsp.log_magnitude(spec, c["log_eps"])
    nf = 1 + max(n - fl, 0) // fs
    emb_a = _context(net, ctx_a, device)
    emb_b = _context(net, ctx_b, device)
    res = tower_windows(net, lm.to(torch.float32), nf, emb_a, emb_b)
    cap = c["recon_residual_cap"]
    if cap > 0:
        res = torch.clamp(res, max=cap)
    spec = spec[:nf]
    mag = spec.abs()
    unit = torch.where(mag > 0, spec / torch.clamp(mag, min=1e-300),
                       torch.ones_like(spec))
    den = dsp.istft(torch.exp(lm[:nf] + res.to(torch.float64)) * unit, fl, fs)
    mix = dsp.istft(torch.exp(lm[:nf]) * unit, fl, fs)
    d2 = float(torch.sum(den * den))
    r2 = float(torch.sum((mix - den) ** 2))
    return {"denoised": den.cpu().numpy(), "snr_est": d2 / max(r2, 1e-12)}
