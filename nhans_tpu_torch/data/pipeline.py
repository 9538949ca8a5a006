"""The training batch built on the device: mixing -> spectrogram ->
synchronised random crops, the port of
``nhans_tpu/data/pipeline.py::make_train_batch``; and the evaluation
windows of one utterance (``make_eval_batch``).

Shapes are fixed per call: waveform buffers [B, L] with valid lengths
[B]; the spectrogram has F = num_frames(L) frames, of which ``nf[b]`` are
valid.  The four spectrograms go through ``dsp.spectral.log_spectrogram``,
which is the CUDA kernel for a CUDA tensor.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.dsp import mixing as mx
from nhans_tpu_torch.dsp import spectral as sp
from nhans_tpu_torch.dsp.windowing import (pad_amounts, pad_for_windowing,
                                           rest_crop_indices,
                                           window_gather_indices)
from nhans_tpu_torch.utils.device import to_device

Draws = Dict[str, torch.Tensor]


def _whole_frames(n: torch.Tensor, frame_length: int,
                  frame_step: int) -> torch.Tensor:
    """A length trimmed to a whole number of frames."""
    return n - torch.remainder(torch.clamp(n - frame_length, min=0),
                               frame_step)


def _valid_frames(n: torch.Tensor, frame_length: int,
                  frame_step: int) -> torch.Tensor:
    return 1 + torch.clamp(n - frame_length, min=0) // frame_step


def train_snr_set(cfg: Config):
    """The task's SNRs (dB), with {12, 18, 30} appended under
    ``snr_augment``."""
    snrs = list(cfg.task.snr_set)
    return snrs + [12, 18, 30] if cfg.data.snr_augment else snrs


def draw_train_batch(cfg: Config, batch: int, slices: int,
                     generator: torch.Generator) -> Draws:
    """Every random draw of one training batch, from ``generator`` on its
    device: the SNR indices ``snr_a``/``snr_b`` [B], the uniforms of the
    window start ``u_win`` and of the two context offsets
    ``u_ctx_a``/``u_ctx_b`` [B, K], and for ``augment_noise`` the shift
    (before the modulo), reversal and polarity of each noise [B]."""
    B, K, g = batch, slices, generator
    n_snr = len(train_snr_set(cfg))

    def ints(high):
        return torch.randint(0, high, (B,), generator=g, device=g.device)

    def uniform():
        return torch.rand((B, K), generator=g, device=g.device)

    draws = {"snr_a": ints(n_snr), "snr_b": ints(n_snr), "u_win": uniform(),
             "u_ctx_a": uniform(), "u_ctx_b": uniform()}
    if cfg.data.augment_noise and cfg.task.two_noise_mixing:
        for s in ("a", "b"):
            draws[f"shift_{s}"] = ints(1 << 30)
            draws[f"rev_{s}"] = ints(2).bool()
            draws[f"sign_{s}"] = ints(2).float() * 2.0 - 1.0
    return draws


def _augment(x: torch.Tensor, n: torch.Tensor, shift: torch.Tensor,
             rev: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Circular shift, optional reversal and polarity of each row within
    its valid length; zero beyond it.  Peak-invariant."""
    n = torch.clamp(n.to(torch.int64), min=1)
    shift = shift.to(torch.int64) % n
    ar = torch.arange(x.shape[-1], device=x.device)[None, :]
    fwd = torch.remainder(shift[:, None] + ar, n[:, None])
    bwd = torch.remainder(shift[:, None] - ar, n[:, None])
    idx = torch.where(rev[:, None], bwd, fwd)
    out = torch.gather(x, 1, idx)
    mask = (ar < n[:, None]).to(x.dtype)
    return out * mask * sign.to(x.dtype)[:, None]


@torch.no_grad()
def make_train_batch(cfg: Config, clean: torch.Tensor, noise_a: torch.Tensor,
                     noise_b: torch.Tensor, clean_len: torch.Tensor,
                     len_a: torch.Tensor, len_b: torch.Tensor,
                     slices: Optional[int] = None,
                     peaks: Optional[torch.Tensor] = None,
                     draws: Optional[Draws] = None,
                     generator: Optional[torch.Generator] = None,
                     rows: Optional[tuple] = None
                     ) -> Dict[str, torch.Tensor]:
    """A training minibatch from raw waveform buffers (int16 or float32,
    at int16 scale).

    For the denoiser ``noise_a``/``noise_b`` are the positive and negative
    noises; for the separator ``noise_a`` is the interfering utterance and
    ``noise_b`` is unused.  ``peaks`` [B, 3] are whole-file peaks from the
    loader.  The random draws come from ``draws`` (see
    ``draw_train_batch``) or, without it, from ``generator``.  Under data
    parallelism the buffers are this rank's rows of the global batch and
    ``rows`` = (first row, global rows) places them: the draws are the
    global batch's (from ``generator``, or ``draws`` for all of its rows)
    and this rank keeps its own, so that the batch does not depend on the
    number of ranks.

    Returns mixed windows [N, W, F], target central frames [N, F], the
    two contexts [N, C, F] and the SNRs [N], with N = B * slices."""
    a, m, task = cfg.audio, cfg.model, cfg.task
    fl, fs = a.frame_length, a.frame_step
    K = int(slices or cfg.data.slices_per_step)
    B, L = clean.shape
    W, C = m.window_frames, m.context_frames
    pad_before = pad_amounts(W)[0]
    dev = clean.device
    first, total = rows or (0, B)
    if draws is None:
        draws = draw_train_batch(cfg, total, K, generator)
    draws = {k: to_device(v[first:first + B], dev) for k, v in draws.items()}

    # the int16 wire type is cast here, on the device
    clean = clean.to(torch.float32)
    noise_a = noise_a.to(torch.float32)
    noise_b = noise_b.to(torch.float32)
    clean_len = clean_len.to(dev, torch.int64)

    def fit(noise, nlen):
        """Align a noise buffer to the speech length L: keep the first L
        samples (and clamp the valid length) or zero-pad."""
        nlen = nlen.to(dev, torch.int64)
        nL = noise.shape[-1]
        if nL > L:
            return noise[..., :L], torch.clamp(nlen, max=L)
        if nL < L:
            return torch.nn.functional.pad(noise, (0, L - nL)), nlen
        return noise, nlen

    noise_a, len_a = fit(noise_a, len_a)
    noise_b, len_b = fit(noise_b, len_b)

    if cfg.data.augment_noise and task.two_noise_mixing:
        noise_a = _augment(noise_a, len_a, draws["shift_a"], draws["rev_a"],
                           draws["sign_a"])
        noise_b = _augment(noise_b, len_b, draws["shift_b"], draws["rev_b"],
                           draws["sign_b"])

    def pk(i):
        return peaks[:, i].to(dev) if peaks is not None else None

    clean_len = _whole_frames(clean_len, fl, fs)
    clean = mx.peak_normalize(clean, clean_len, pk(0))
    noise_a = mx.peak_normalize(noise_a, len_a, pk(1))

    snr_set = to_device(torch.tensor(train_snr_set(cfg),
                                      dtype=torch.float32), dev)
    snr_a = snr_set[draws["snr_a"]]
    snr_b = snr_set[draws["snr_b"]]

    if task.two_noise_mixing:
        noise_b = mx.peak_normalize(noise_b, len_b, pk(2))
        mixed, target, pos_s, neg_s = mx.mix_two_noise(
            clean, noise_a, noise_b, clean_len, len_a, len_b, snr_a, snr_b)
        ctx_src_a, ctx_src_b = pos_s, neg_s
        ctx_len_a = ctx_len_b = clean_len
    else:
        tgt, _, mixed, k = mx.mix_one_noise(clean, noise_a, clean_len,
                                            len_a, snr_a)
        target = tgt
        # the interfering speaker at its full length, the target speaker
        ctx_src_a = k[..., None] * noise_a
        ctx_src_b = tgt
        ctx_len_a, ctx_len_b = len_a, clean_len

    # log-magnitude only: training never uses the phase
    lm_mixed = sp.log_spectrogram(mixed, fl, fs, a.log_eps)
    lm_target = sp.log_spectrogram(target, fl, fs, a.log_eps)
    lm_ctx_a = sp.log_spectrogram(ctx_src_a, fl, fs, a.log_eps)
    lm_ctx_b = sp.log_spectrogram(ctx_src_b, fl, fs, a.log_eps)
    F = lm_mixed.shape[1]
    nf = _valid_frames(clean_len, fl, fs)                       # [B]
    nf_ctx_a = _valid_frames(ctx_len_a, fl, fs)
    nf_ctx_b = _valid_frames(ctx_len_b, fl, fs)

    # frames past the valid region are zero (the reference's exact-length
    # spectrograms, zero-padded), not log(eps) of the padded tail
    far = torch.arange(F, device=dev)[None, :, None]

    def zero_tail(lm, n_valid):
        return lm * (far < n_valid[:, None, None]).to(lm.dtype)

    lm_mixed = zero_tail(lm_mixed, nf)
    lm_target = zero_tail(lm_target, nf)
    lm_ctx_a = zero_tail(lm_ctx_a, nf_ctx_a)
    lm_ctx_b = zero_tail(lm_ctx_b, nf_ctx_b)

    lm_mixed_p = pad_for_windowing(lm_mixed, W)
    lm_ctx_a_p = pad_for_windowing(lm_ctx_a, W)
    lm_ctx_b_p = pad_for_windowing(lm_ctx_b, W)
    nfeat = lm_mixed.shape[2]

    def take_frames(lm_p, idx):
        """lm_p [B, T, nfeat], idx [B, K, n] -> [B, K, n, nfeat]."""
        n = idx.shape[-1]
        flat = idx.reshape(B, K * n, 1).expand(B, K * n, nfeat)
        return torch.gather(lm_p, 1, flat).reshape(B, K, n, nfeat)

    # synchronised crops: winstart in [0, nf - 1] of padded coordinates
    u = draws["u_win"].to(torch.float32)
    winstart = (u * nf[:, None].to(torch.float32)).to(torch.int64)  # [B, K]
    widx = winstart[..., None] + torch.arange(W, device=dev)[None, None, :]
    mixed_win = take_frames(lm_mixed_p, widx)                   # [B,K,W,nf]
    # target: the central frame of the padded window, in original
    # coordinates winstart + W // 2 - pad_before (winstart for odd W,
    # one later for even W)
    center = winstart + (W // 2) - pad_before
    tidx = torch.minimum(torch.clamp(center, min=0),
                         torch.clamp(nf[:, None] - 1, min=0))
    target_c = torch.gather(
        lm_target, 1, tidx.reshape(B, K, 1).expand(B, K, nfeat))

    def ctx_crop(lm_p, uk, nf_src):
        """C consecutive padded frames of the rest of the source, the
        window at ``winstart`` cut out; a source with fewer than C + 1
        valid frames is tiled cyclically from its real frames."""
        rest_max = torch.clamp(nf_src[:, None] - 1 - C, min=0)     # [B, 1]
        r = (uk.to(torch.float32) * (rest_max + 1).to(torch.float32)
             ).to(torch.int64)                                     # [B, K]
        ar = torch.arange(C, device=dev)[None, None, :]
        idx = rest_crop_indices(r[..., None], C, winstart[..., None],
                                W)                                 # [B,K,C]
        short = (nf_src[:, None, None] - 1) < C                    # [B,1,1]
        idx_short = pad_before + ar % torch.clamp(
            nf_src, min=1)[:, None, None]
        idx = torch.where(short, idx_short, idx)
        idx = torch.clamp(idx, max=F + W - 2)                      # in buffer
        return take_frames(lm_p, idx)

    ctx_a = ctx_crop(lm_ctx_a_p, draws["u_ctx_a"], nf_ctx_a)       # [B,K,C,nf]
    ctx_b = ctx_crop(lm_ctx_b_p, draws["u_ctx_b"], nf_ctx_b)

    return {
        "mixed": mixed_win.reshape(B * K, W, nfeat),
        "target": target_c.reshape(B * K, nfeat),
        "ctx_a": ctx_a.reshape(B * K, C, nfeat),
        "ctx_b": ctx_b.reshape(B * K, C, nfeat),
        "snr_a": torch.repeat_interleave(snr_a, K),
        "snr_b": torch.repeat_interleave(snr_b, K),
    }


def make_eval_batch(cfg: Config, mixed: torch.Tensor, target: torch.Tensor,
                    ctx_a_sig: torch.Tensor, ctx_b_sig: torch.Tensor,
                    n: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Deterministic evaluation windows of ONE utterance (signals [1, L],
    ``n`` [1] its valid length), the port of
    ``nhans_tpu/data/pipeline.py::make_eval_batch``: the first
    ``context_frames`` frames give the two contexts, and the model sees a
    window at every frame (stride 1) of the rest.  ``valid`` marks the
    windows whose frame lies within the utterance; ``mixed_ph`` is the
    mixture's phase, arctan2(im, re)."""
    a, m = cfg.audio, cfg.model
    fl, fs = a.frame_length, a.frame_step
    W, C = m.window_frames, m.context_frames

    lm_mixed, re, im = sp.spectrogram_reim(mixed, fl, fs, a.log_eps)
    lm_target = sp.log_spectrogram(target, fl, fs, a.log_eps)
    lm_a = sp.log_spectrogram(ctx_a_sig, fl, fs, a.log_eps)
    lm_b = sp.log_spectrogram(ctx_b_sig, fl, fs, a.log_eps)

    nf = _valid_frames(_whole_frames(n, fl, fs), fl, fs)
    nwin = lm_mixed.shape[-2] - C
    rest = lm_mixed[..., C:, :]
    padded = pad_for_windowing(rest, W)
    dev = lm_mixed.device
    return {
        "mixed": padded[..., window_gather_indices(nwin, W, device=dev), :],
        "target": lm_target[..., C:, :],
        "mixed_lm": rest,
        "mixed_ph": torch.atan2(im, re)[..., C:, :],
        "ctx_a": lm_a[..., :C, :],
        "ctx_b": lm_b[..., :C, :],
        "valid": torch.arange(nwin, device=dev) < (nf - C),
        "num_windows": torch.clamp(nf - C, min=0),
    }
