"""Benchmark harness of the port: the counterpart of the root ``bench.py``.

    python -m nhans_tpu_torch.bench [--mode infer|train|suite] [--iters N]
        [--dtype float32|bfloat16] [--freq_pad_to N] [--banked]
        [--reference_root DIR]

runs on the card, and nowhere else: without one it exits non-zero and
prints no result.  Each mode drives the port's own main path at full
width and prints ONE JSON line, the last line of its output, with the
keys of ``bench.py``'s line and the card that gave it: ``card`` (name and
power limit as nvidia-smi gives them) and ``device_kind``
(``torch.cuda.get_device_name``).

* ``infer`` (the default): the serving real-time factor of a batch of
  ``--batch`` utterances of ``--seconds`` s (16 x 10 s) through
  ``Enhancer.enhance_stream`` with ``window_chunk`` 2048, after one warm
  ``enhance_batch``, by the host's clock up to the read-back of the last
  batch.  The inputs are ``bench.py``'s: the seven DEMO_N-HANS mixtures
  looped to length when ``<reference_root>/DEMO_N-HANS/denoising`` exists,
  else its synthetic batch from ``np.random.default_rng(0)``.  The
  weights are the port's seeded random init (``models.random_init_state``):
  its ``last_dense`` is zero, as flax's is, so the output is the JAX
  ``PRNGKey(0)`` output, and the tower still runs every convolution.
  ``bench.py``'s ``vs_baseline`` is left out: it divides by the 50x
  target that ``BASELINE.md`` sets for one TPU v5e chip, which says
  nothing of this card.
* ``train``: steps/s, windows/s and ``mfu_est`` of the full-width
  denoiser step (``train/step.py``) on ``--train_utts`` utterances x 4
  crops, one warm step, then ``--iters`` steps by the host's clock ending
  in ``.item()`` of the loss.  Streamed: ``bench.py``'s int16 batch of
  ``max_samples``, on the card before the timing; ``--banked``: its 128
  bank rows of 63,920 samples and index triples, under the keys of
  ``data/banks.py::DeviceBanks``.  Every step draws from a generator
  seeded with 1, as ``bench.py`` passes ``PRNGKey(1)`` to every step.
  ``flops_per_step`` is ``torch.utils.flop_counter.FlopCounterMode``'s
  count of one more, untimed step: convolutions and matrix products
  only (XLA's ``cost_analysis``, which ``bench.py`` reads, also counts
  elementwise work), and not the spectrogram kernel, which it cannot
  see.  ``mfu_est`` divides the rate by the H100's published dense peak
  of the step's compute dtype: 67 TFLOP/s in float32 (TF32 stays off)
  and 989 TFLOP/s in bfloat16.
* ``suite``: ``bench.py``'s five single-call configurations over the
  files under ``--reference_root`` (``N_HANS___Selective_Noise``,
  ``N_HANS___Source_Separation`` and ``DEMO_N-HANS``), each call's RTF by
  the host's clock after one warm call; the last is five minutes of the
  exp2 mixture tiled, through ``Enhancer.enhance_long``.  It serves in
  float32, taking ``--freq_pad_to`` and not ``--dtype``, as ``bench.py``'s
  suite does, and refuses to run without the tree.

The process's TF32, cuDNN autotuner and memory-format settings are left
as the program leaves them.  ``--reference_root`` has no default, where
``bench.py`` names the reference checkout: without it ``infer`` takes the
synthetic batch and ``suite`` refuses.  The mode functions take a
``device``, so that the CPU tests can reach them; ``main`` takes the
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.infer.enhance import Enhancer
from nhans_tpu_torch.models import random_init_state
from nhans_tpu_torch.tools.devtime import card
from nhans_tpu_torch.train.step import create_state, make_train_step
from nhans_tpu_torch.utils import wavio
from nhans_tpu_torch.utils.device import resolve_device

# H100 SXM dense peaks by compute dtype (NVIDIA data sheet, 700 W)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# what every line adds to bench.py's keys
CARD_KEYS = ("card", "device_kind")
# the banked corpus of bench.py: N rows of a 4 s segment bucket
BANK_ROWS = 128
BANK_SAMPLES = 63920
LONG_SECONDS = 300

Batch = Tuple[list, list, list]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m nhans_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="infer",
                   choices=("infer", "train", "suite"))
    p.add_argument("--batch", type=int, default=16,
                   help="utterances per call")
    p.add_argument("--train_utts", type=int, default=16,
                   help="utterances per train step (x slices_per_step=4 "
                        "crops = 64 windows, the reference minibatch)")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="utterance length (s)")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--window_chunk", type=int, default=2048,
                   help="windows per model call in serving")
    p.add_argument("--freq_pad_to", type=int, default=0,
                   help="carry the main tower's frequency axis on this "
                        "many columns (ModelConfig.freq_pad_to); 0 = the "
                        "native geometry")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="compute dtype of infer and train")
    p.add_argument("--reference_root", default="",
                   help="root of the reference audio tree (--mode suite; "
                        "the DEMO batch of --mode infer)")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="--mode infer: the synthetic batch even where the "
                        "DEMO audio exists")
    p.add_argument("--banked", action="store_true", default=False,
                   help="--mode train: the device-bank (indexed) step "
                        "instead of the streamed-batch step")
    return p.parse_args(argv)


def _check_finite(x, what: str) -> None:
    if not np.isfinite(x).all():
        raise RuntimeError(f"{what}: output is not finite")


def count_flops(fn) -> int:
    """Floating-point operations of ``fn()`` as torch counts them: 2 per
    multiply-add of its convolutions and matrix products."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

def serving_config(args, task: str = "denoiser",
                   with_dtype: bool = True) -> Config:
    """The task's Config with ``--freq_pad_to`` and, unless
    ``with_dtype`` is False (``bench.py``'s suite), ``--dtype``."""
    cfg = getattr(Config, task)()
    fpad = max(args.freq_pad_to, 0)
    dtype = args.dtype if with_dtype else "float32"
    if dtype != "float32" or fpad:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype=dtype, freq_pad_to=fpad))
    return cfg


def make_enhancer(cfg: Config, args, device, weights=None) -> Enhancer:
    """The harness's Enhancer: ``weights`` (a ``state_dict``), else the
    seeded random init."""
    if weights is None:
        weights = random_init_state(cfg)
    return Enhancer(cfg, weights, window_chunk=args.window_chunk,
                    device=device)


def _demo_examples(demo: str) -> List[Dict[str, str]]:
    """Each DEMO example directory's files, keyed by the part of the name
    after its last ``_`` (``mixed.wav``, ``negNoise.wav``), in name
    order."""
    out = []
    for ex in sorted(os.listdir(demo)):
        d = os.path.join(demo, ex)
        if os.path.isdir(d):
            out.append({f.split("_")[-1]: os.path.join(d, f)
                        for f in os.listdir(d)})
    return out


def infer_inputs(args, fs: int) -> Tuple[list, list, list, str]:
    """(mixed, pos, neg, audio_source) of ``--mode infer``, as
    ``bench.py`` builds them."""
    n = int(args.seconds * fs)
    rng = np.random.default_rng(0)
    demo = os.path.join(args.reference_root, "DEMO_N-HANS", "denoising")
    if args.reference_root and not args.synthetic and os.path.isdir(demo):
        # the DEMO mixtures looped or cut to the bench length, dealt round
        # robin to fill the batch, each with its own negNoise context
        src = []
        for files in _demo_examples(demo):
            m = wavio.read_for_processing(files["mixed.wav"])
            g = wavio.read_for_processing(files["negNoise.wav"])
            reps = -(-n // max(len(m), 1))
            src.append((np.tile(m, reps)[:n], g))
        mixed = [src[i % len(src)][0] for i in range(args.batch)]
        neg = [src[i % len(src)][1] for i in range(args.batch)]
        pos = [np.zeros(fs)] * args.batch
        return mixed, pos, neg, "demo7_real"
    mixed = [rng.standard_normal(n) * 2000 for _ in range(args.batch)]
    pos = [np.zeros(fs)] * args.batch
    neg = [rng.standard_normal(fs * 3) * 800 for _ in range(args.batch)]
    return mixed, pos, neg, "synthetic"


def serve(enh: Enhancer, batch: Batch, iters: int) -> Tuple[float, dict]:
    """One warm ``enhance_batch``, then ``iters`` batches through
    ``enhance_stream``: (seconds they took, the last batch's outputs)."""
    out = enh.enhance_batch(*batch)
    _check_finite(out["denoised"][0], "warm batch")
    t0 = time.perf_counter()
    # each batch's outputs come back to the host: the last read-back
    # waits for the card
    for out in enh.enhance_stream(batch for _ in range(iters)):
        pass
    return time.perf_counter() - t0, out


def bench_infer(args, device="cuda", cfg=None, weights=None
                ) -> Tuple[dict, dict]:
    """(result line, the last batch's outputs) of ``--mode infer``."""
    cfg = cfg or serving_config(args)
    enh = make_enhancer(cfg, args, device, weights)
    mixed, pos, neg, source = infer_inputs(args, cfg.audio.sample_rate)
    elapsed, out = serve(enh, (mixed, pos, neg), args.iters)
    rtf = args.batch * args.seconds * args.iters / elapsed
    return {"metric": "denoise_rtf_per_chip", "value": round(rtf, 2),
            "unit": "x_realtime", "audio_source": source}, out


# --------------------------------------------------------------------- #
# the single-call suite
# --------------------------------------------------------------------- #

def suite_inputs(root: str, fs: int = 16000
                 ) -> Tuple[Dict[str, Tuple[str, list, list, list]], tuple]:
    """The suite's calls over the tree under ``root``: {config: (task,
    mixed, pos, neg)} for the four batch calls, and (mixed, pos, neg) of
    the five-minute segmented call."""
    aex = os.path.join(root, "N_HANS___Selective_Noise", "audio_examples")
    ss_aex = os.path.join(root, "N_HANS___Source_Separation",
                          "audio_examples")
    demo = os.path.join(root, "DEMO_N-HANS", "denoising")
    if not root or not os.path.isdir(aex):
        raise SystemExit(f"--mode suite needs the reference audio tree at "
                         f"--reference_root (got {root!r})")

    def rd(*path):
        return wavio.read_for_processing(os.path.join(*path), fs)

    silent = rd(aex, "Silent.wav")
    exp2, exp2_noise = rd(aex, "exp2_noisy.wav"), rd(aex, "exp2_noise.wav")
    examples = _demo_examples(demo)
    calls = {
        # single-wav denoise (exp2): the reference README's primary use
        "denoise_exp2_single": ("denoiser", [exp2], [silent], [exp2_noise]),
        # selective suppression (exp1): keep +noise, remove -noise
        "selective_exp1": ("denoiser", [rd(aex, "exp1_noisy.wav")],
                           [rd(aex, "exp1_+noise.wav")],
                           [rd(aex, "exp1_-noise.wav")]),
        # folder-batch mode: every DEMO denoising mixture in one batch
        "folder_batch_demo7": (
            "denoiser",
            [wavio.read_for_processing(f["mixed.wav"], fs) for f in examples],
            [silent] * len(examples),
            [wavio.read_for_processing(f["negNoise.wav"], fs)
             for f in examples]),
        # separation on mixed.wav with the speaker contexts
        "separation_mixed": ("separator", [rd(ss_aex, "mixed.wav")],
                             [rd(ss_aex, "target_speaker.wav")],
                             [rd(ss_aex, "noise_speaker.wav")]),
    }
    n = LONG_SECONDS * fs
    long = (np.tile(exp2, -(-n // len(exp2)))[:n], silent, exp2_noise)
    return calls, long


def timed(enh: Enhancer, batch: Batch, iters: int) -> Tuple[float, dict]:
    """(RTF, outputs) of ``enhance_batch`` over ``iters`` calls after a
    warm one."""
    out = enh.enhance_batch(*batch)
    _check_finite(out["denoised"][0], "warm call")
    t0 = time.perf_counter()
    for _ in range(iters):
        out = enh.enhance_batch(*batch)
    dt = (time.perf_counter() - t0) / iters
    seconds = sum(len(m) for m in batch[0]) / enh.cfg.audio.sample_rate
    return round(seconds / dt, 2), out


def timed_long(enh: Enhancer, mixed, pos, neg, **segments
               ) -> Tuple[float, dict]:
    """(RTF, outputs) of one ``enhance_long`` call after a warm one;
    ``segments`` go to ``enhance_long`` (its 32 s segments by default)."""
    out = enh.enhance_long(mixed, pos, neg, **segments)
    _check_finite(out["denoised"], "warm long call")
    t0 = time.perf_counter()
    out = enh.enhance_long(mixed, pos, neg, **segments)
    dt = time.perf_counter() - t0
    return round(len(mixed) / enh.cfg.audio.sample_rate / dt, 2), out


def bench_suite(args, device="cuda") -> dict:
    """The result line of ``--mode suite``."""
    calls, long = suite_inputs(args.reference_root)
    enhs = {task: make_enhancer(serving_config(args, task, False), args,
                                device)
            for task in ("denoiser", "separator")}
    configs = {name: timed(enhs[task], (m, a, b), args.iters)[0]
               for name, (task, m, a, b) in calls.items()}
    configs["long_audio_5min_segmented"] = timed_long(enhs["denoiser"],
                                                      *long)[0]
    # single-call latency on short audio; the baseline for interactive use
    # is real time (1x), whatever the device
    low = min(configs.values())
    return {"metric": "suite_min_rtf_single_call", "value": low,
            "unit": "x_realtime", "baseline": 1.0,
            "baseline_name": "interactive real-time (1x)",
            "regime": "single_call", "vs_baseline": round(low / 1.0, 3),
            "configs": configs}


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #

def train_config(args) -> Config:
    cfg = Config.denoiser()
    if args.dtype != "float32" or args.freq_pad_to:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype=args.dtype,
            freq_pad_to=args.freq_pad_to))
    return cfg


def train_inputs(args, cfg: Config) -> Dict[str, Dict[str, np.ndarray]]:
    """``bench.py``'s step inputs as numpy arrays: {"banks", "idx"} with
    ``--banked``, else {"batch"}."""
    B = args.train_utts
    rng = np.random.default_rng(0)
    if args.banked:
        N, L = BANK_ROWS, BANK_SAMPLES
        banks = {
            "speech": (rng.standard_normal((N, L)) * 3000).astype(np.int16),
            "speech_len": np.full((N,), L, np.int32),
            "speech_peak": np.full((N,), 9000.0, np.float32),
        }
        banks["noise"] = banks["speech"]
        banks["noise_len"] = banks["speech_len"]
        banks["noise_peak"] = banks["speech_peak"]
        idx = {k: rng.integers(N, size=B).astype(np.int32)
               for k in ("clean_idx", "a_idx", "b_idx")}
        return {"banks": banks, "idx": idx}
    L = cfg.data.max_samples
    batch = {
        "clean": (rng.standard_normal((B, L)) * 3000).astype(np.int16),
        "noise_a": (rng.standard_normal((B, L)) * 3000).astype(np.int16),
        "noise_b": (rng.standard_normal((B, L)) * 3000).astype(np.int16),
        "clean_len": np.full((B,), L, np.int32),
        "len_a": np.full((B,), L, np.int32),
        "len_b": np.full((B,), L, np.int32),
        "peaks": np.full((B, 3), 9000.0, np.float32),
    }
    return {"batch": batch}


def bench_train(args, device="cuda", cfg=None) -> Tuple[dict, float]:
    """(result line, the warm step's loss) of ``--mode train``."""
    cfg = cfg or train_config(args)
    model, state, tx = create_state(cfg, torch.Generator().manual_seed(0),
                                    device)
    step = make_train_step(cfg, model, tx, banked=args.banked)
    on_card = {name: {k: torch.from_numpy(v).to(device)
                      for k, v in arrays.items()}
               for name, arrays in train_inputs(args, cfg).items()}
    inputs = ((on_card["banks"], on_card["idx"]) if args.banked
              else (on_card["batch"],))

    def run():
        return step(state, *inputs, torch.Generator().manual_seed(1))

    first = run()["loss"].item()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        metrics = run()
    metrics["loss"].item()
    dt = (time.perf_counter() - t0) / args.iters
    flops = count_flops(run)

    windows = args.train_utts * cfg.data.slices_per_step
    peak = PEAK_FLOPS[cfg.model.compute_dtype]
    return {
        "metric": "train_windows_per_sec_per_chip",
        "value": round(windows / dt, 1),
        "unit": "windows/s",
        "vs_baseline": round((windows / dt) / 64.0, 3),  # ref mb / s = 1
        "steps_per_sec": round(1.0 / dt, 3),
        "step_ms": round(dt * 1e3, 2),
        "flops_per_step": flops,
        "mfu_est": round(flops / dt / peak, 4) if flops else None,
        "dtype": args.dtype,
        "windows_per_step": windows,
        "pipeline": "banked" if args.banked else "streamed",
    }, first


# --------------------------------------------------------------------- #

def card_fields(device) -> dict:
    """The card that gave a line: nvidia-smi's name and power limit, and
    torch's name for it."""
    return {"card": card(), "device_kind": torch.cuda.get_device_name(device)}


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nhans_tpu_torch.bench measures the card, and "
                         "torch.cuda.is_available() is False")
    device = resolve_device("cuda")
    if args.mode == "infer":
        line = bench_infer(args, device)[0]
    elif args.mode == "train":
        line = bench_train(args, device)[0]
    else:
        line = bench_suite(args, device)
    line.update(card_fields(device))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
