"""Training steps of the reference: the banked batch, forward, backward and
the update, as N-HANS trains.

A step takes B bank rows (utterances at int16 scale with their lengths
and whole-file peaks) and their random draws: each row is trimmed to whole
frames and divided by its peak; the separator mixes one interfering row
at the drawn SNR (the mixture over its own peak; the target is the clean
row), the denoiser a positive and a negative noise, each looped to the
speech's length (mixture and target over the mixture's peak).  Four
log-magnitude spectrograms (mixture, target, both context sources), zero
past each source's valid frames, give K synchronised crops per row: a
35-frame window of the mixture at ``floor(u * frames)``, the target's
central frame, and from each context source 200 consecutive frames of what
is left with that window cut out (tiled when the source is short).  The
loss is the frequency-weighted MSE (weights 2 -> 1 over the bins) of the
central frame plus the predicted residual against the target.  BatchNorm
takes the batch's moments.  The update is optax's sgd or adam.

The waveforms are mixed in float32 and the index arithmetic runs in
float32, as the configuration states, so that a crop lands on the same
frame and a real bin whose magnitude comes near zero (|X| ~ 1e-5, where
log(|X| + 1e-5) magnifies a change of the waveform's last bit to 1e-2)
sees the same samples; the spectra are taken in float64 of those float32
waveforms, the network in float32.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import dsp
from benchmark.reference.model import Net, Params


def _mask(n: torch.Tensor, L: int) -> torch.Tensor:
    return (torch.arange(L, device=n.device)[None, :] < n[:, None]).float()


def _loop(x: torch.Tensor, n: torch.Tensor, target: torch.Tensor):
    L = x.shape[-1]
    idx = torch.arange(L, device=x.device)[None, :] % torch.clamp(n, min=1)[:, None]
    return torch.gather(x, 1, idx) * _mask(target, L)


def _power(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return (x * x * _mask(n, x.shape[-1])).sum(-1) / torch.clamp(n.float(), min=1.0)


def _gain(ps, pn, snr):
    k = torch.sqrt(ps / torch.where(pn == 0, torch.ones_like(pn), pn)
                   * torch.pow(10.0, -snr / 10.0))
    return torch.where(pn == 0, torch.ones_like(k), k)


def make_batch(cfg: dict, rows: Dict[str, torch.Tensor],
               draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Windows, target frames and both contexts of one step.  ``rows``:
    "clean", "noise_a", "noise_b" [B, L] (int16 scale), "clean_len",
    "len_a", "len_b" [B], "peaks" [B, 3]; ``draws``: "snr_a", "snr_b" [B]
    indices into the SNR set, "u_win", "u_ctx_a", "u_ctx_b" [B, K]."""
    fl, fs, eps = cfg["frame_length"], cfg["frame_step"], cfg["log_eps"]
    W, C = cfg["window_frames"], cfg["context_frames"]
    dev = rows["clean"].device
    B, L = rows["clean"].shape
    K = draws["u_win"].shape[1]
    i64 = lambda t: t.to(dev, torch.int64)  # noqa: E731
    n = i64(rows["clean_len"])
    n = n - torch.remainder(torch.clamp(n - fl, min=0), fs)
    la, lb = i64(rows["len_a"]), i64(rows["len_b"])
    pk = rows["peaks"].to(dev, torch.float32)
    clean = rows["clean"].float() * _mask(n, L) / (pk[:, 0:1] + 1e-6)
    na = rows["noise_a"].float() * _mask(la, L) / (pk[:, 1:2] + 1e-6)
    snrs = torch.tensor(cfg["snr_set"], dtype=torch.float32, device=dev)
    snr_a, snr_b = snrs[i64(draws["snr_a"])], snrs[i64(draws["snr_b"])]
    ps = _power(clean, n)
    if cfg["two_noise_mixing"]:
        nb = rows["noise_b"].float() * _mask(lb, L) / (pk[:, 2:3] + 1e-6)
        pos, neg = _loop(na, la, n), _loop(nb, lb, n)
        pos = _gain(ps, _power(pos, n), snr_a)[:, None] * pos
        neg = _gain(ps, _power(neg, n), snr_b)[:, None] * neg
        mixed = clean + pos + neg
        peak = mixed.abs().amax(-1, keepdim=True) + 1e-6
        mixed, target = mixed / peak, (clean + pos) / peak
        src_a, src_b, len_a, len_b = pos / peak, neg / peak, n, n
    else:
        noise = _loop(na, la, n)
        k = _gain(ps, _power(noise, n), snr_a)
        mixed = clean + k[:, None] * noise
        mixed = mixed / (mixed.abs().amax(-1, keepdim=True) + 1e-6)
        target = clean
        src_a, src_b, len_a, len_b = k[:, None] * na, clean, la, n

    def frames(x):
        return 1 + torch.clamp(x - fl, min=0) // fs

    def spec(x, valid):
        lm = dsp.log_magnitude(dsp.rdft(x, fl, fs), eps).to(torch.float32)
        keep = torch.arange(lm.shape[1], device=dev)[None, :] < valid[:, None]
        return lm * keep[..., None].to(lm.dtype)

    nf, nf_a, nf_b = frames(n), frames(len_a), frames(len_b)
    lm_mixed, lm_target = spec(mixed, nf), spec(target, nf)
    lm_a, lm_b = spec(src_a, nf_a), spec(src_b, nf_b)
    F = lm_mixed.shape[1]
    before = (W + 1) // 2 - 1
    pad = lambda lm: torch.nn.functional.pad(lm, (0, 0, before, W // 2))  # noqa: E731
    bins = lm_mixed.shape[2]

    def take(lm_p, idx):                        # [B, T, bins], [B, K, m]
        m = idx.shape[-1]
        flat = idx.reshape(B, K * m, 1).expand(B, K * m, bins)
        return torch.gather(lm_p, 1, flat).reshape(B, K, m, bins)

    u = draws["u_win"].to(dev, torch.float32)
    start = (u * nf[:, None].to(torch.float32)).to(torch.int64)      # [B, K]
    windows = take(pad(lm_mixed), start[..., None]
                   + torch.arange(W, device=dev)[None, None, :])
    centre = torch.minimum(torch.clamp(start + W // 2 - before, min=0),
                           torch.clamp(nf[:, None] - 1, min=0))
    target_c = take(lm_target, centre[..., None])[:, :, 0]

    def context(lm, uk, nf_src):
        rest = torch.clamp(nf_src[:, None] - 1 - C, min=0)
        r = (uk.to(dev, torch.float32)
             * (rest + 1).to(torch.float32)).to(torch.int64)          # [B, K]
        idx = r[..., None] + torch.arange(C, device=dev)[None, None, :]
        idx = idx + torch.where(idx >= start[..., None], W, 0)
        short = (nf_src[:, None, None] - 1) < C
        tiled = before + (torch.arange(C, device=dev)[None, None, :]
                          % torch.clamp(nf_src, min=1)[:, None, None])
        idx = torch.clamp(torch.where(short, tiled, idx), max=F + W - 2)
        return take(pad(lm), idx)

    ctx_a = context(lm_a, draws["u_ctx_a"], nf_a)
    ctx_b = context(lm_b, draws["u_ctx_b"], nf_b)
    N = B * K
    return {"mixed": windows.reshape(N, W, bins),
            "target": target_c.reshape(N, bins),
            "ctx_a": ctx_a.reshape(N, C, bins),
            "ctx_b": ctx_b.reshape(N, C, bins)}


def loss_of(net: Net, ex: Dict[str, torch.Tensor], half: bool = False):
    """The frequency-weighted MSE of the step's examples; ``half`` keeps the
    first half of them (a fault the comparison has to catch)."""
    if half:
        ex = {k: v[:v.shape[0] // 2] for k, v in ex.items()}
    W = net.cfg["window_frames"]
    res = net.residual(ex["mixed"], net.embed(ex["ctx_a"]),
                       net.embed(ex["ctx_b"]))
    bins = res.shape[-1]
    wts = torch.from_numpy(np.linspace(2.0, 1.0, bins, dtype=np.float32)
                           ).to(res.device)
    se = (ex["mixed"][:, W // 2, :] + res - ex["target"]) ** 2
    return (se * wts).mean(-1).mean()


def run_steps(cfg: dict, variables: Params, steps: List[dict], alg: str,
              lr: float, tf32: bool = False, half: bool = False,
              dtype: torch.dtype = torch.float32) -> dict:
    """The reference's first ``len(steps)`` steps from ``variables``; each
    entry of ``steps`` holds a step's ``rows`` and ``draws``.  Returns the
    losses, each leaf's gradient norm at the first step
    (``grad_norms``) and the norm of each leaf's change after the last
    (``change_norms``).  ``dtype`` float64 runs the network, its gradients
    and the update in float64 on the same float32 batch: a witness of what
    float32's rounding alone does to these numbers."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = {k: v.to(dtype, copy=True).requires_grad_(True)
              for k, v in variables.items() if k.startswith("params/")}
    start = {k: v.detach().clone() for k, v in params.items()}
    stats = {k: v.to(dtype) for k, v in variables.items()
             if not k.startswith("params/")}
    net = Net(cfg, {**params, **stats}, train=True, tf32=tf32)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad_norms = [], None
    for t, step in enumerate(steps, start=1):
        with torch.no_grad():
            ex = {k: v.to(dtype) for k, v in
                  make_batch(cfg, step["rows"], step["draws"]).items()}
        loss = loss_of(net, ex, half)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if grad_norms is None:
                grad_norms = {k[len("params/"):]: float(torch.linalg.vector_norm(g))
                              for k, g in zip(params, grads)}
            for (k, p), g in zip(params.items(), grads):
                if alg == "sgd":
                    p -= lr * g
                elif alg == "adam":
                    mu[k] = 0.9 * mu[k] + 0.1 * g
                    nu[k] = 0.999 * nu[k] + 0.001 * g * g
                    # the bias corrections in float32, as optax takes them
                    m_hat = mu[k] / float(np.float32(1) - np.float32(0.9) ** t)
                    v_hat = nu[k] / float(np.float32(1)
                                          - np.float32(0.999) ** t)
                    p -= lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
                else:
                    raise ValueError(f"no reference update for alg {alg!r}")
    change = {k[len("params/"):]: float(torch.linalg.vector_norm(
        params[k].detach() - start[k])) for k in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
