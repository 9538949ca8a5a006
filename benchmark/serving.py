"""What the serving drivers share: the program's engine built from the
configuration file, the traffic's audio, and the comparison of served
utterances with the reference."""

from __future__ import annotations

import dataclasses
import hashlib
import math
import sys
from typing import List

import numpy as np
import torch

from benchmark import flops, traffic
from benchmark.harness import BenchError, Run


def port_config(cfg: dict):
    """The program's Config for a configuration file, refused where the
    program would run other sizes than the file states."""
    from nhans_tpu_torch.config import Config, TaskConfig

    base = Config.denoiser() if cfg["task"] == "denoiser" else Config.separator()
    audio = dataclasses.replace(base.audio, sample_rate=cfg["sample_rate"],
                                log_eps=cfg["log_eps"],
                                recon_residual_cap=cfg["recon_residual_cap"])
    if (audio.frame_length, audio.frame_step, audio.num_features) != (
            cfg["frame_length"], cfg["frame_step"], cfg["num_bins"]):
        raise BenchError("the program's STFT geometry is not the config's")
    model = dataclasses.replace(
        base.model, window_frames=cfg["window_frames"],
        context_frames=cfg["context_frames"], num_features=cfg["num_bins"],
        embedding_dim=cfg["embedding_dim"],
        pos_embed_hidden=cfg["pos_embed_hidden"], bn_eps=cfg["bn_eps"],
        bn_decay=cfg["bn_decay"], compute_dtype=cfg["dtype"],
        main_blocks=tuple(tuple(b) for b in cfg["main_blocks"]),
        context_blocks=tuple((tuple(k), tuple(s), c)
                             for k, s, c in cfg["context_blocks"]))
    task = TaskConfig(name=cfg["task"], snr_set=tuple(cfg["snr_set"]),
                      two_noise_mixing=cfg["two_noise_mixing"])
    data = dataclasses.replace(base.data, max_samples=cfg["max_samples"],
                               slices_per_step=cfg["slices_per_step"])
    return base.replace(audio=audio, model=model, task=task, data=data)


def weights_path(run: Run) -> str:
    """The configuration's weights, refused unless they are the ones the
    configuration names by hash."""
    path = run.path(run.config["weights"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != run.config["weights_sha256"]:
        raise BenchError(f"{run.config['weights']} is not the checkpoint "
                         "the configuration names (sha256 differs)")
    return path


def make_enhancer(run: Run):
    from nhans_tpu_torch.compat.weights import load_npz
    from nhans_tpu_torch.infer.enhance import Enhancer

    return Enhancer(port_config(run.config), load_npz(weights_path(run)),
                    window_chunk=run.workload["traffic_params"]["window_chunk"],
                    device=run.device)


def contexts(run: Run, g: torch.Generator, rng: np.random.Generator,
             count: int):
    """``count`` pairs of (positive, negative) noise sources, each a
    context of ``context_s`` seconds followed by 25 s to mix from."""
    tp, sr = run.workload["traffic_params"], run.config["sample_rate"]
    n_ctx = [int(rng.uniform(*tp["context_s"]) * sr) for _ in range(2 * count)]
    src = traffic.noise(g, [c + 25 * sr for c in n_ctx], sr)
    return [((src[2 * i][:n_ctx[2 * i]], src[2 * i][n_ctx[2 * i]:]),
             (src[2 * i + 1][:n_ctx[2 * i + 1]], src[2 * i + 1][n_ctx[2 * i + 1]:]))
            for i in range(count)]


def mixtures(run: Run, g, rng, lengths, pair) -> List[np.ndarray]:
    """Voices of ``lengths`` mixed with both noises of a context pair."""
    voices = traffic.speech(g, lengths, run.config["sample_rate"])
    snrs = run.workload["traffic_params"]["snr_db"]
    return [traffic.snr_mix(rng, v, [pair[0][1], pair[1][1]], snrs)
            for v in voices]


def frames(run: Run, n: int) -> int:
    """Valid frames of an utterance of ``n`` samples."""
    c = run.config
    return 1 + max(n - c["frame_length"], 0) // c["frame_step"]


def trimmed(run: Run, n: int) -> int:
    c = run.config
    return n - (n - c["frame_length"]) % c["frame_step"]


def bucket(run: Run, lengths) -> int:
    """Samples a batch is served on: the smallest length bucket that holds
    its longest utterance trimmed to whole frames."""
    n = max(trimmed(run, int(x)) for x in lengths)
    sr = run.config["sample_rate"]
    return next((int(s * sr) for s in run.config["length_buckets_s"]
                 if int(s * sr) >= n), n)


def flop_report(run: Run, fn, windows: int) -> None:
    """The yardstick's count of ``windows`` real windows beside the
    program's own count (``FlopCounterMode``) of the call ``fn``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    port = counter.get_total_flops()
    mine = windows * flops.window_flops(run.config)
    print(f"flops: yardstick {mine} ({windows} real windows x "
          f"{flops.window_flops(run.config)}), program's FlopCounterMode "
          f"{port}, ratio {port / max(mine, 1):.6f}", file=sys.stderr,
          flush=True)


def compare(run: Run, served: List[dict]) -> List[dict]:
    """Each served utterance of ``served`` ({"mixed", "ctx_a", "ctx_b",
    "pad_to", "denoised", "snr_est"}) against the reference: the widest
    gap of a waveform sample over the reference's peak, and the SNR
    estimate's relative gap, each the largest over the sample."""
    from benchmark.reference.model import Net, load_variables
    from benchmark.reference.serve import enhance

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = Net(run.config, load_variables(weights_path(run), run.device))
    wav, snr = 0.0, 0.0
    for u in served:
        ref = enhance(net, u["mixed"], u["ctx_a"], u["ctx_b"], u["pad_to"],
                      run.device)
        den = np.asarray(u["denoised"], np.float64)
        if den.shape != ref["denoised"].shape or not np.isfinite(den).all():
            wav = snr = math.inf
            continue
        peak = max(float(np.max(np.abs(ref["denoised"]))), 1e-12)
        wav = max(wav, float(np.max(np.abs(den - ref["denoised"]))) / peak)
        snr = max(snr, abs(float(u["snr_est"]) - ref["snr_est"])
                  / max(abs(ref["snr_est"]), 1e-12))
    limits = run.workload["check"]["limits"]
    return [{"name": "wav_gap", "value": wav, "limit": limits["wav_gap"]},
            {"name": "snr_gap", "value": snr, "limit": limits["snr_gap"]}]


def sample(run: Run, done: List[dict]) -> List[dict]:
    """The utterances to compare: ``check.sample`` of those served, drawn
    from the seed, and the longest."""
    rng = np.random.default_rng([run.seed, 7])
    k = min(run.workload["check"]["sample"], len(done))
    picks = set(rng.choice(len(done), size=k, replace=False).tolist())
    picks.add(max(range(len(done)), key=lambda i: len(done[i]["mixed"])))
    return [done[i] for i in sorted(picks)]


def well_formed(run: Run, u: dict) -> bool:
    """An answer of the right length with finite samples."""
    c = run.config
    n_out = c["frame_step"] * (frames(run, len(u["mixed"])) - 1) + c["frame_length"]
    den = u["denoised"]
    return len(den) == n_out and bool(np.isfinite(den).all()) and \
        math.isfinite(float(u["snr_est"]))


def sync(run: Run) -> None:
    """Wait for the run's device."""
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()


def release() -> None:
    """Return the memory of the program's dropped state to the card before
    the reference runs."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
