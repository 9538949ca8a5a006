#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nhans_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It
builds the CUDA kernel from csrc/, holds it against its plain PyTorch
version at the serving and training shapes, times it by device time, then
drives the port's two main paths at full width:

* serving seeded utterances with the shipped weights
  (docs/quality/*_q5_swa.npz): the denoiser (against the same Enhancer on
  the plain spectrogram and against the JAX package's golden output in
  tests/data/torch_golden_denoiser.npz), the segmented long-audio path,
  the separator, and the denoiser command line;
* training: one sgd step against the JAX package's training golden
  (tests/data/torch_golden_train.npz), then ``nhans_tpu_torch.cli.train``
  on a seeded synthetic corpus in a temporary directory: the denoiser on
  the corpus banked on the card and streamed from the host, the separator
  banked, a checkpoint and an auto-resume that replays the uninterrupted
  run; step time by CUDA events, FLOPs per step, peak memory;
* evaluation: the Evaluator against the JAX package's golden pass
  (tests/data/torch_golden_eval.npz), the shipped denoiser and separator
  scoring the corpus's 8 valid utterances in one group at [8, 256000]
  with the kernel and with the plain spectrogram (card time by CUDA
  events, host scoring time, TFLOP/s, peak memory), the trainer's
  synchronous and asynchronous scoring of a checkpoint, and
  ``nhans_tpu_torch.cli.evaluate`` and ``tools/eval_checkpoints``
  rescoring it;
* the training options: one full-width bfloat16 sgd step against the JAX
  package's (tests/data/torch_golden_train_bf16.npz); step time (CUDA
  events), TFLOP/s and peak memory in float32 and bfloat16 with sgd and
  Adam, with and without --remat (whose step must equal the plain one)
  and with --freq_pad_to 256; serving with NHANS_FREQ_PAD=256 against the
  native geometry, with its RTF; and ``nhans_tpu_torch.cli.train --dtype
  bfloat16 --remat --profile_dir`` for 21 steps, whose trace must name the
  kernel's launches, whose checkpoint is scored in bfloat16 and whose wavs
  the native decoder (csrc/nhans_native.cpp, built with g++) read;
* several ranks (phase 15): the mesh step in an NCCL world of one against
  the training golden; two ranks sharing the card over gloo (NCCL refuses
  two ranks on one device), each spawned as a process of its own with a
  file:// store: the banked full-width data-parallel step against the
  1-rank step and against the JAX package's make_mesh(data=2) step
  (tests/data/torch_golden_train_dp.npz), per-rank step times, launches
  and peak memory, data=1 x model=2 against the 1-rank steps, and
  ``cli.train`` on both ranks with a checkpoint and an auto-resume; the
  Enhancer split over two replicas; with two cards or more, the same over
  NCCL and the denoiser command line with --mesh auto.

Any failed check raises, and the script exits non-zero without its result
line.  Without a CUDA card, or without the rest of the repository, it
exits non-zero at once.

``python3 chip_smoke.py --cards`` runs phase 15 (f) alone on a machine
with two cards or more.

The last lines are the card's name and power limit as nvidia-smi gives
them, one JSON object with the kernel's numbers on each path, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script writes nothing into the repository apart from build/.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, dense bfloat16 on them, and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# The least work of the spectrogram per frame, with an FFT: 2.5 N log2 N
# operations for a real 400-point FFT (half the 5 N log2 N of a complex
# one), 400 for the window, about 5 per bin for the log-magnitude.  The
# kernel's own FFT does about 11,300 (its source's header); the bound
# counts what the function needs, not what a kernel does.
SPECTROGRAM_OPS_PER_FRAME = 2.5 * 400 * np.log2(400) + 400 + 5 * 201

# kernel against plain, the bars of tests/test_pallas_ops.py
LM_ATOL = 5e-3
REIM_RTOL = 5e-3  # x max|re|
# re/im against the plain version taken in float64: the float32 FFT's
# rounding (about 2e-7 x max|re|), far from what a wrong index gives
REIM_EXACT_RTOL = 1e-5  # x max|re|
# served waveforms (peak about 1) on the card against the card on the plain
# spectrogram, against the JAX package's golden output (CPU) and against
# the unsegmented call: 1e-3 absolute, snr_est 1e-3 relative.  It leaves
# room for cuDNN's choice of algorithm per shape; a wrong window, phase or
# frame offset moves the waveforms by 1e-1.
WAVE_ATOL = 1e-3
SNR_RTOL = 1e-3
# one full-width sgd step on the card against the JAX package's step on a
# CPU: the loss within 1e-4 relative, the gradient norm within 1e-3
# relative (the JAX one is itself 7e-5 from float64, its first context
# convolution's weight gradient rounded coarsely), each recorded update
# within 1e-3 of its largest |delta|, BatchNorm statistics within 1e-4 +
# 1e-3 relative
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 1e-3
TRAIN_DELTA_RTOL = 1e-3
# the loss of the first step after an auto-resume against the
# uninterrupted run's (cuDNN's backward sums in another order each run)
RESUME_RTOL = 1e-4
# one full-width bfloat16 sgd step on the card against the JAX package's
# bfloat16 step (tests/data/torch_golden_train_bf16.npz). bfloat16 keeps 8
# significant bits, and the step's own rounding noise exceeds how far it
# lies from the float32 step. The file records three distances of the JAX
# step: gap/<key> to its float32 step, spread/<key> under a 1e-6 relative
# perturbation of the weights (the most over 4 draws), and strict/<key> to
# the same step compiled to round every bfloat16 value the program names
# (XLA on a CPU keeps some intermediates in float32 by default; the port
# rounds where the program says). In loss the spread exceeds the gap
# (1.6e-3 against 4.1e-4), and at the last BatchNorm strict moves
# pop_variance by 4.5e-2 against a gap of 9.9e-3: the port on a CPU lies
# 4.5e-2 away there, as far as the JAX step lies from itself under the
# other rounding. So loss, gradient norm, each update and the last
# BatchNorm's statistics are held to BF16_SPREAD_X times the largest of
# the three; what tells bfloat16 from float32 is the first BatchNorm's
# statistics (the first convolution's output, where roundings do not mix:
# 1e-6 absolute against a 2.5e-6 gap, the port on a CPU 4.8e-7) and the
# dtype of every convolution's operands (all bfloat16).
BF16_SPREAD_X = 4.0
BF16_FIRST_BN_ATOL = 1e-6
# biases whose exact gradient is zero (a BatchNorm takes the shift out):
# their updates are rounding noise, compared by nothing
NOISE_BIASES = ("conv2.b", "transform.b", "proj_a.b", "proj_b.b")
# timed full-width steps a run (after 2 warm ones), and the padded width
STEP_RUNS = 6
# phase 15: the data-parallel global batch (utterances) and its timed steps
DP_UTTS = 16
STEPS_DP = 3
FREQ_PAD = 256
# evaluation metrics (loss, dB, STOI, ESTOI, PESQ, counts) on the card
# against the plain spectrogram, the JAX package's golden pass (CPU), the
# trainer's other pass and cli.evaluate: |diff| <= SNR_RTOL x max(|value|,
# 1); reconstructions within WAVE_ATOL

SR = 16000


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(msg):
    print(msg, flush=True)


def utterance(rng, seconds, f0):
    """int16-scale float64: a harmonic tone with a moving pitch in noise."""
    t = np.arange(int(round(seconds * SR))) / SR
    phase = 2 * np.pi * np.cumsum(f0 + 30 * np.sin(2 * np.pi * 0.5 * t)) / SR
    voice = sum(np.sin(h * phase) / h for h in range(1, 6))
    return 7000 * voice + rng.standard_normal(len(t)) * 1500


def write_corpus(root, rng):
    """A seeded int16 corpus under root with train/valid/test manifests.
    Train: 8 speech utterances of 4 to 10.2 s by 4 speakers and 6 noises
    of 3 to 12 s.  Valid (written after train, so the train split does not
    depend on it): 8 speech utterances of 5.2 to 10.225 s by 4 other
    speakers, one group of the evaluator on its 16 s bucket, and 6 noises
    of 6 to 12 s.  Returns (speech_dir, noise_dir)."""
    from scipy.io import wavfile

    from nhans_tpu_torch.data.manifest import create_seeds

    splits = (
        ("train", (("speech", (10.225, 9.1, 7.3, 10.0, 4.2, 8.8, 10.225,
                               6.0)),
                   ("noise", (12.0, 3.0, 10.225, 5.5, 9.0, 7.7)))),
        ("valid", (("speech", (10.225, 8.4, 6.1, 9.7, 10.225, 5.2, 7.9,
                               9.3)),
                   ("noise", (12.0, 6.0, 10.225, 8.5, 11.0, 7.2)))))
    for kind in ("speech", "noise"):
        for split in ("train", "valid", "test"):
            os.makedirs(os.path.join(root, kind, split))
    for split, kinds in splits:
        for kind, seconds in kinds:
            for i, sec in enumerate(seconds):
                x = (utterance(rng, sec, 120 + 25 * i) if kind == "speech"
                     else rng.standard_normal(int(sec * SR)) * (800 + 300 * i))
                spk = i % 4 + (4 if split == "valid" else 0)
                wavfile.write(
                    os.path.join(root, kind, split, f"spk{spk}_{i}.wav"), SR,
                    np.clip(np.rint(x), -32768, 32767).astype(np.int16))
    dirs = []
    for kind in ("speech", "noise"):
        create_seeds(os.path.join(root, kind))
        dirs.append(os.path.join(root, kind) + "/")
    return dirs


@contextmanager
def plain_spectrogram(stft_cuda):
    """Serve with the plain spectrogram on the card, for comparison: taken
    in float64 and returned in float32.  The float32 plain version misses
    float64 by up to 4e-2 in log-magnitude where a bin's magnitude comes
    within a few 1e-5 of zero (phase 3), which moves the loss of a window
    that holds such a bin by more than the evaluation's bar; the kernel
    stays within a few 1e-4 of float64 there."""
    kernel = stft_cuda.log_spectrogram_kernel

    def plain64(x, with_reim=False):
        out = stft_cuda.log_spectrogram_plain(x.double(), with_reim)
        return (tuple(t.float() for t in out) if with_reim
                else out.float())

    stft_cuda.log_spectrogram_kernel = plain64
    try:
        yield
    finally:
        stft_cuda.log_spectrogram_kernel = kernel


def compare(got, ref, what, keys=("denoised", "mixed_processed", "removed")):
    errs = {}
    for key in keys:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        check(g.shape == r.shape, f"{what} {key}: shape {g.shape} != {r.shape}")
        errs[key] = float(np.abs(g - r).max()) if g.size else 0.0
        check(errs[key] <= WAVE_ATOL, f"{what} {key}: max |diff| "
              f"{errs[key]:.3g} > {WAVE_ATOL}")
    g, r = np.asarray(got["snr_est"]), np.asarray(ref["snr_est"])
    rel = float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-12)))
    check(rel <= SNR_RTOL, f"{what} snr_est: rel diff {rel:.3g} > {SNR_RTOL}")
    say(f"  {what}: max |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; snr_est rel diff {rel:.3g}")


def compare_metrics(got, want, what):
    """Metrics (numbers, or arrays of per-utterance numbers) at the
    evaluation bar."""
    check(set(got) == set(want), f"{what}: metric keys {sorted(got)} != "
          f"{sorted(want)}")
    diffs = {}
    for k in want:
        g, w = (np.asarray(x, np.float64) for x in (got[k], want[k]))
        check(g.shape == w.shape, f"{what} {k}: shape")
        d = np.abs(g - w)
        check(bool(np.all(d <= SNR_RTOL * np.maximum(np.abs(w), 1.0))),
              f"{what} {k}: {g} against {w}")
        diffs[k] = float(d.max())
    say(f"  {what}: max |diff| " + ", ".join(f"{k} {v:.3g}"
                                            for k, v in diffs.items()))


def compare_dumps(got_dir, want_dir, what):
    """The dumped reconstructions (and per-window losses) of two passes."""
    names = sorted(os.listdir(want_dir))
    check(sorted(os.listdir(got_dir)) == names, f"{what}: dumped files")
    worst = {}
    for name in names:
        g = np.load(os.path.join(got_dir, name))
        w = np.load(os.path.join(want_dir, name))
        check(g.shape == w.shape, f"{what} {name}: shape")
        kind = name.split("_")[-2]
        err = float(np.abs(g - w).max()) if g.size else 0.0
        bar = (SNR_RTOL * max(float(np.abs(w).max()), 1.0) if kind == "loss"
               else WAVE_ATOL)
        check(err <= bar, f"{what} {name}: max |diff| {err:.3g} > {bar:.3g}")
        worst[kind] = max(worst.get(kind, 0.0), err)
    say(f"  {what}: {len(names)} dumped arrays, max |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))


def step_errors(got, want, what):
    """A step's record (``port_train_golden``'s keys) against another at
    phase 8's bars; a line that says how far it lay."""
    from tests.make_torch_golden import TRAIN_LAYERS, TRAIN_STATS

    rel = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
           for k in ("loss", "grad_norm")}
    check(rel["loss"] <= TRAIN_LOSS_RTOL, f"{what} loss: rel {rel['loss']}")
    check(rel["grad_norm"] <= TRAIN_GNORM_RTOL,
          f"{what} grad norm: rel {rel['grad_norm']}")
    delta_errs = {}
    for path in TRAIN_LAYERS:
        w = np.asarray(want[f"delta/{path}"])
        err = float(np.abs(got[f"delta/{path}"] - w).max() / np.abs(w).max())
        check(err <= TRAIN_DELTA_RTOL, f"{what} update {path}: {err}")
        delta_errs[path] = err
    for path in TRAIN_STATS:
        for name in ("pop_mean", "pop_variance"):
            key = f"stats/{path}/{name}"
            check(np.allclose(got[key], want[key], atol=1e-4, rtol=1e-3),
                  f"{what} {key}")
    return (f"{what}: loss {float(got['loss']):.6f} (against "
            f"{float(want['loss']):.6f}, rel {rel['loss']:.2g}), grad norm "
            f"{float(got['grad_norm']):.5f} (against "
            f"{float(want['grad_norm']):.5f}, rel {rel['grad_norm']:.2g}); "
            "updates, max |diff| / max |delta|: " + ", ".join(
                f"{k} {v:.2g}" for k, v in delta_errs.items()))


def step_record(model, before, metrics):
    """``port_train_golden``'s keys of a step on ``model`` (full
    tensors), ``before`` its flat flax parameters before the step."""
    from nhans_tpu_torch.compat.weights import to_flax
    from tests.make_torch_golden import TRAIN_LAYERS, TRAIN_STATS

    after = to_flax(dict(model.named_parameters()), "params")
    stats = to_flax(dict(model.named_buffers()), "stats")
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"])}
    for path in TRAIN_LAYERS:
        out[f"delta/{path}"] = (after[f"params/{path}"]
                                - before[f"params/{path}"])
    for path in TRAIN_STATS:
        for name in ("pop_mean", "pop_variance"):
            out[f"stats/{path}/{name}"] = stats[f"stats/{path}/{name}"]
    return out


def rank_phase15(rank, world, spec_path):
    """One of phase 15's ranks (``run_ranks``), with every rank on the
    card ``spec["device"]`` (or its own, ``cuda:{LOCAL_RANK}``, for None):

    (b) the banked full-width data-parallel step from the shipped weights
        (its record, then ``STEPS_DP`` more steps timed by CUDA events, the
        kernel's launches, peak memory, and the gradient buffer's
        all-reduce timed alone), and the data-parallel golden's step;
    (d) with ``spec["model_axis"]``, two steps on data=1 x model=world;
    (c) with ``spec["cli"]``, ``cli.train`` for 4 steps and a checkpoint,
        then again to step 6 from its auto-resume.

    Writes its results to ``<out>.<rank>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from nhans_tpu_torch.cli import train as cli_train
    from nhans_tpu_torch.compat.weights import load_npz, to_flax
    from nhans_tpu_torch.data.banks import BankIndexLoader, DeviceBanks
    from nhans_tpu_torch.models import build_model
    from nhans_tpu_torch.ops import stft_cuda
    from nhans_tpu_torch.parallel.mesh import make_mesh
    from nhans_tpu_torch.parallel.sharding_rules import (gather_full,
                                                         model_shards,
                                                         shard_model)
    from nhans_tpu_torch.train.step import (make_train_step, make_tx,
                                            state_of, step_generator)
    from nhans_tpu_torch.utils.device import resolve_device
    from tests.make_torch_golden import (DENOISER_NPZ, GOLDEN_TRAIN_DP,
                                         port_train_golden)

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    cfg, seed = spec["cfg"], spec["seed"]
    dev = resolve_device(spec["device"] or "cuda")
    torch.cuda.set_device(dev)
    out = {"device": str(dev)}
    dbanks = DeviceBanks(cfg, dev)

    def on_card(idx):
        return {k: torch.from_numpy(v).to(dev) for k, v in idx.items()}

    def shipped(mesh):
        model = build_model(cfg)
        model.load_state_dict(load_npz(DENOISER_NPZ))
        model.to(dev)
        before = to_flax(dict(model.named_parameters()), "params")
        shard_model(model, mesh)
        tx = make_tx(cfg)
        return model, before, tx, state_of(model, tx)

    # (b) the data-parallel step: this rank's rows of the global batch
    mesh = make_mesh(data=world)
    model, before, tx, state = shipped(mesh)
    step = make_train_step(cfg, model, tx, banked=True, mesh=mesh)
    idx = BankIndexLoader(dbanks, spec["batch_utts"],
                          shard=(mesh.data_index, mesh.data))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stft_cuda.log_spectrogram_kernel.launches = 0
    m = step(state, dbanks.banks, on_card(next(idx)), step_generator(seed, 0))
    out["b"] = step_record(model, before, m)
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(spec["steps"] + 1)]
    ev[0].record()
    for i in range(spec["steps"]):
        step(state, dbanks.banks, on_card(next(idx)),
             step_generator(seed, i + 1))
        ev[i + 1].record()
    torch.cuda.synchronize(dev)
    out["launches"] = stft_cuda.log_spectrogram_kernel.launches
    out["rows"] = spec["batch_utts"] // world
    out["step_ms"] = [ev[i].elapsed_time(ev[i + 1])
                      for i in range(spec["steps"])]
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    flat = torch.zeros(sum(p.numel() for p in model.parameters()),
                       device=dev)
    out["grad_elements"] = flat.numel()
    allreduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=mesh.data_group)
        torch.cuda.synchronize(dev)
        allreduce_ms.append(1e3 * (time.perf_counter() - t0))
    out["allreduce_ms"] = allreduce_ms
    del model, state, step, flat
    torch.cuda.empty_cache()
    with np.load(GOLDEN_TRAIN_DP) as z:
        golden = {k: z[k] for k in z.files}
    out["dp_golden"] = port_train_golden(dev, golden, mesh=mesh)
    torch.cuda.empty_cache()

    # (d) the model axis: both ranks on the whole batch, the wide kernels
    # split between them
    if spec["model_axis"]:
        tp = make_mesh(data=1, model=world)
        model, _, tx, state = shipped(tp)
        shards = model_shards(model)
        out["blocks"] = {k: tuple(state.params[k].shape) for k in shards}
        step = make_train_step(cfg, model, tx, banked=True, mesh=tp)
        idx = BankIndexLoader(dbanks, spec["batch_utts"])
        out["tp_loss"] = [float(step(state, dbanks.banks, on_card(next(idx)),
                                     step_generator(seed, i))["loss"])
                          for i in range(2)]
        full = gather_full(dict(model.named_parameters()), shards)
        if rank == 0:
            out["tp_params"] = {k: v.detach().cpu().numpy()
                                for k, v in full.items()}
        del model, state, step, full
        torch.cuda.empty_cache()
    del dbanks
    torch.cuda.empty_cache()

    # (c) the training command line on every rank
    if spec["cli"]:
        args = spec["cli"] + ["--device", str(dev)]
        first = cli_train.build_trainer(args + ["--batches", "4"])
        first.train()
        again = cli_train.build_trainer(args + ["--batches", "6"])
        out["c"] = {"first": first.tstep, "resumed_at": again.tstep,
                    "mesh": (again.mesh.data, again.mesh.model),
                    "local_utts": again.local_utts}
        again.train()
        out["c"].update(last=again.tstep, ckpt_steps=again.ckpt.steps(),
                        banked=again.banked)
    with open(f"{spec['out']}.{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def dp_reference(corpus):
    """The 1-rank reference of phase 15 (b), (d) and (f): two banked sgd
    steps from the shipped weights (every layer live) on the corpus, the
    global batch of ``DP_UTTS`` utterances.  Returns (config, generator
    seed, the first step's record, both losses, the weights after both)."""
    import torch

    from nhans_tpu_torch.compat.weights import load_npz, to_flax
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.data.banks import BankIndexLoader, DeviceBanks
    from nhans_tpu_torch.models import build_model
    from nhans_tpu_torch.train.step import (make_train_step, make_tx,
                                            state_of, step_generator)
    from tests.make_torch_golden import DENOISER_NPZ

    dev = torch.device("cuda", 0)
    base = Config.denoiser()
    cfg = base.replace(data=dataclasses.replace(
        base.data, speech_wav_dir=corpus[0], noise_wav_dir=corpus[1]))
    seed = cfg.data.seed + 17
    dbanks = DeviceBanks(cfg, dev)
    idx_loader = BankIndexLoader(dbanks, DP_UTTS)
    model = build_model(cfg)
    model.load_state_dict(load_npz(DENOISER_NPZ))
    model.to(dev)
    before = to_flax(dict(model.named_parameters()), "params")
    tx = make_tx(cfg)
    state = state_of(model, tx)
    step = make_train_step(cfg, model, tx, banked=True)

    def idx():
        return {k: torch.from_numpy(v).to(dev)
                for k, v in next(idx_loader).items()}

    ref = step_record(model, before, step(state, dbanks.banks, idx(),
                                          step_generator(seed, 0)))
    losses = [ref["loss"], float(step(state, dbanks.banks, idx(),
                                      step_generator(seed, 1))["loss"])]
    params = {k: v.detach().cpu().numpy()
              for k, v in model.named_parameters()}
    del model, state, step, dbanks
    torch.cuda.empty_cache()
    return cfg, seed, ref, losses, params


def dp_golden():
    from tests.make_torch_golden import (GOLDEN_TRAIN_DP, golden_dp_inputs,
                                         input_digest)

    with np.load(GOLDEN_TRAIN_DP) as z:
        gold = {k: z[k] for k in z.files}
    check(str(gold["input_sha256"]) == input_digest(
        *golden_dp_inputs().values()), "data-parallel golden inputs")
    return gold


def run_phase15_ranks(spec, backend):
    """``rank_phase15`` on two ranks: (each rank's results, wall s)."""
    import pickle

    from tests.make_torch_golden import run_ranks

    path = f"{spec['out']}.spec"
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    t0 = time.perf_counter()
    run_ranks(2, "chip_smoke:rank_phase15", path, backend=backend,
              timeout=900)
    wall = time.perf_counter() - t0
    res = []
    for r in range(2):
        with open(f"{spec['out']}.{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res, wall


def check_data_parallel(res, tag, ref, gold, smi):
    """Phase 15 (b)'s checks of each rank's results: its step against the
    1-rank step and the ranks' step on the data-parallel golden, at phase
    8's bars, and the kernel's launches; prints the times."""
    for r, rec in enumerate(res):
        check(rec["launches"] == 4 * (1 + STEPS_DP),
              f"{tag} rank {r}: {rec['launches']} kernel launches in "
              f"{1 + STEPS_DP} steps")
        say(f"{tag} rank {r} on {rec['device']}: " + step_errors(
            rec["b"], ref, "its step against the 1-rank step"))
        say(f"  rank {r}: {rec['rows']} utterances x 4 crops a step, "
            f"ms per step by CUDA events "
            + ", ".join(f"{v:.1f}" for v in rec["step_ms"])
            + f"; {rec['launches']} kernel launches; peak memory "
            f"{rec['peak_gib']:.2f} GiB; all-reduce of the "
            f"{rec['grad_elements']} float32 gradient elements alone "
            + ", ".join(f"{v:.1f}" for v in rec["allreduce_ms"])
            + f" ms; on {smi}")
    say(f"{tag} " + step_errors(
        res[0]["dp_golden"], gold, "the 2-rank step on the data-parallel "
        "golden against the JAX make_mesh(data=2) step"))


def check_mesh_auto(served, count):
    """The denoiser command line with --mesh auto on ``count`` cards
    against the 1-card Enhancer's output (phase 15 (f))."""
    from scipy.io import wavfile

    from tests.make_torch_golden import DENOISER_NPZ

    den, mixed, _, neg, _ = served
    with tempfile.TemporaryDirectory() as ftmp:
        wavfile.write(os.path.join(ftmp, "in.wav"), SR,
                      np.rint(mixed[1]).astype(np.int16))
        wavfile.write(os.path.join(ftmp, "neg.wav"), SR,
                      np.rint(neg).astype(np.int16))
        r = subprocess.run(
            [sys.executable, "-m", "nhans_tpu_torch.cli.denoiser",
             "--checkpoint", DENOISER_NPZ, "--mesh", "auto", "--input",
             os.path.join(ftmp, "in.wav"), "--neg",
             os.path.join(ftmp, "neg.wav"), "--pos", "", "--output",
             os.path.join(ftmp, "out.wav")], cwd=REPO,
            capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"--mesh auto CLI failed:\n{r.stderr}")
        n = 1 << (count.bit_length() - 1)
        check(f"serving sharded over {n} devices" in r.stderr,
              "--mesh auto did not split")
        want = den.enhance(mixed[1], np.zeros(SR), neg)
        err = float(np.abs(wavfile.read(os.path.join(ftmp, "out.wav"))[1]
                           - want["denoised"]).max())
        check(err <= WAVE_ATOL, f"--mesh auto output: {err}")
    say(f"[15f serving] --mesh auto over {n} cards: max |diff| {err:.3g} "
        "from the 1-card Enhancer")


def phase15(tmp, corpus, smi, count, tgold, banked_losses, served):
    """Phase 15: the port on several ranks, every rank on the one card.

    (a) NCCL in a world of one: the golden step through the mesh step.
    (b) Two ranks over gloo sharing cuda:0: the banked full-width step of
        16 utterances x 4 crops, 8 a rank, equals the 1-rank step from the
        shipped weights on the same draws and indices; the two ranks' step
        on the data-parallel golden equals the JAX make_mesh(data=2) step.
    (c) cli.train on the two ranks: 4 steps, rank 0's checkpoint, an
        auto-resume of both at step 4, step 5's loss against phase 9's.
    (d) data=1 x model=2 over gloo: two steps equal the 1-rank steps at
        the JAX test's bars (loss 1e-4 relative, weights 5e-5).
    (e) the Enhancer split over [cuda:0, cuda:0] equals phase 5's.
    (f) with two cards or more: (b) over NCCL on two cards, and the
        denoiser command line with --mesh auto.
    Returns the data-parallel rank's kernel numbers for the result."""
    import torch
    import torch.distributed as dist

    from nhans_tpu_torch.compat.weights import load_npz
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.infer.enhance import Enhancer
    from nhans_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from tests.make_torch_golden import DENOISER_NPZ, port_train_golden

    torch.cuda.empty_cache()

    # (a) NCCL, a world of one
    store = tempfile.mkdtemp(prefix="nccl_", dir=tmp)
    initialize_multihost(f"file://{store}/store", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(data=1)
        check(dist.get_backend() == "nccl" and mesh.data_group is not None,
              "a world of one on NCCL with its data group")
        got = port_train_golden("cuda", tgold, mesh=mesh)
        say("[15a nccl] world of one on cuda:0, " + step_errors(
            got, tgold, "the mesh step on the training golden (JAX, CPU)"))
    finally:
        dist.destroy_process_group()

    cfg, seed, ref, ref_losses, ref_params = dp_reference(corpus)
    gold = dp_golden()
    cli = ["--speech_wav_dir", corpus[0], "--noise_wav_dir", corpus[1],
           "--checkpoint_dir", f"{tmp}/ck_ranks", "--summaries_dir",
           f"{tmp}/sum_ranks", "--eval_utts", "0", "--train_monitor_every",
           "1", "--eval_every", "4"]
    spec = dict(cfg=cfg, seed=seed, device="cuda:0", batch_utts=DP_UTTS,
                steps=STEPS_DP, model_axis=True, cli=cli, out=f"{tmp}/p15")

    # (b), (c) and (d) in one pair of processes
    res, wall = run_phase15_ranks(spec, "gloo")
    check_data_parallel(res, "[15b gloo]", ref, gold, smi)
    say("  gloo moves CUDA tensors through the host: these times say "
        "nothing of NCCL's scaling; both ranks share one card")

    # (d) the model axis
    for r, rec in enumerate(res):
        check(rec["blocks"], f"rank {r}: no kernel held as a block")
        for name, shape in rec["blocks"].items():
            dim = 0 if len(shape) == 4 else 1
            check(shape[dim] * 2 == ref_params[name].shape[dim],
                  f"{name}: block {shape}")
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(rec["tp_loss"], ref_losses))
        check(rel <= 1e-4, f"model axis rank {r}: losses {rec['tp_loss']} "
              f"against {ref_losses}")
    worst = max(float(np.abs(res[0]["tp_params"][k] - v).max())
                for k, v in ref_params.items())
    check(worst <= 5e-5, f"model axis weights: max |diff| {worst}")
    say(f"[15d model axis] data=1 x model=2 over gloo, {len(res[0]['blocks'])}"
        f" kernels held as halves (e.g. resblock8.conv2.w "
        f"{res[0]['blocks'].get('resblock8.conv2.w')}): losses of 2 steps "
        + ", ".join(f"{v:.6f}" for v in res[0]["tp_loss"]) + " against "
        + ", ".join(f"{v:.6f}" for v in ref_losses)
        + f" (1 rank); weights within {worst:.3g} of the 1-rank run's")

    # (c) the command line
    for r, rec in enumerate(res):
        c = rec["c"]
        check(c["first"] == 4 and c["resumed_at"] == 4 and c["last"] == 6
              and c["ckpt_steps"] == [4, 6] and c["banked"]
              and c["mesh"] == (2, 1) and c["local_utts"] == DP_UTTS // 2,
              f"cli.train rank {r}: {c}")
    with open(f"{tmp}/sum_ranks/nhans.jsonl") as f:
        losses = {r["step"]: r["loss"] for r in map(json.loads, f)
                  if "loss" in r}
    check(sorted(losses) == [1, 2, 3, 4, 5, 6], f"rank 0's record: {losses}")
    rel = abs(losses[5] - banked_losses[5]) / abs(banked_losses[5])
    check(rel <= RESUME_RTOL, f"2-rank resumed step 5: loss {losses[5]} "
          f"against {banked_losses[5]} (phase 9, 1 rank)")
    say(f"[15c cli] cli.train on 2 ranks (gloo, cuda:0): 4 steps, rank 0's "
        f"checkpoint, both resumed at step 4, to step 6; losses "
        + ", ".join(f"{losses[k]:.7f}" for k in sorted(losses))
        + f"; step 5 rel diff {rel:.2g} from phase 9's 1-rank run; the "
        f"three phases' processes took {wall:.1f} s")

    # (e) serving split over two replicas on the one card
    _, mixed, pos, neg, out = served
    two = Enhancer(Config.denoiser(), load_npz(DENOISER_NPZ),
                   devices=["cuda:0", "cuda:0"])
    got = two.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    for i in range(len(mixed)):
        compare({k: v[i] for k, v in got.items()},
                {k: v[i] for k, v in out.items()},
                f"[15e serving] Enhancer(devices=[cuda:0, cuda:0]) against "
                f"phase 5's, utterance {i}")
    del two

    # (f) two cards
    if count >= 2:
        res_f, _ = run_phase15_ranks(dict(spec, device=None, model_axis=False,
                                          cli=None, out=f"{tmp}/p15f"),
                                     "nccl")
        check_data_parallel(res_f, "[15f nccl]", ref, gold, smi)
        check_mesh_auto(served, count)
    else:
        say("[15f] one card: NCCL between two cards and --mesh auto over "
            "several are not run here")
    return {"launches": res[0]["launches"], "rows": res[0]["rows"],
            "launches_rank1": res[1]["launches"]}


def timed_groups(evaluator):
    """Wrap the evaluator's device work per group: (card ms by CUDA events
    from its first copy to the host to its last, host wall s) for each."""
    import torch

    forward = evaluator._forward
    log = []

    def wrapped(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = forward(*args)
        ev[1].record()
        ev[1].synchronize()
        log.append((ev[0].elapsed_time(ev[1]), time.perf_counter() - t0))
        return out

    evaluator._forward = wrapped
    return log


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from nhans_tpu_torch.cli._app import load_enhancer
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.dsp import spectral as sp
    from nhans_tpu_torch.ops import _build, stft_cuda
    from nhans_tpu_torch.tools.devtime import device_ms, sleep_cycles_per_ms
    from tests.make_torch_golden import (DENOISER_NPZ, GOLDEN, GOLDEN_EVAL,
                                         GOLDEN_TRAIN, GOLDEN_TRAIN_BF16,
                                         SEPARATOR_NPZ,
                                         TRAIN_LAYERS, TRAIN_STATS,
                                         eval_digest, golden_eval_examples,
                                         golden_inputs, golden_train_inputs,
                                         input_digest, port_eval_golden,
                                         port_train_golden)

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # -- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"[1 device] {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    _, record = _build.load("log_spectrogram")
    say(f"[2 build] {os.path.relpath(record['path'], REPO)} in "
        f"{record['seconds']:.2f} s")
    for line in record["ptxas"]:
        say(f"  {line}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        check(spills is None or spills.groups() == ("0", "0"),
              f"ptxas reports spills: {line}")

    # -- 3. kernel against its plain version, at the paths' shapes -------
    # Against the plain version taken in float64 (the exact answer): the
    # log-magnitude within LM_ATOL, re/im within REIM_EXACT_RTOL x max|re|.
    # Against the float32 plain version: re/im within REIM_RTOL x max|re|,
    # the log-magnitude within LM_ATOL at every bin where that version is
    # nearer float64 than the kernel.  At [64, 160000] (12.8M bins) some
    # |X[0]| or |X[200]| of noise lies within a few 1e-5 of zero, where the
    # float32 plain version misses float64 by up to 4e-2 in log-magnitude
    # and the kernel, which sums those bins in float64, does not.  Serving:
    # contexts [8, 32240] and mixed [4, 160000]; training: [16, 163600]
    # log-only on the banked path and [16, 64000], the first length bucket,
    # on the streaming path; evaluation: [8, 256000] with re/im, a group of
    # 8 on the 16 s bucket.
    rng = np.random.default_rng(0)
    kernel_errs = {}
    shapes = [((1, 160000), True), ((4, 160000), True), ((8, 160000), True),
              ((8, 32240), False), ((16, 32240), False),
              ((16, 163600), False), ((16, 64000), False),
              ((8, 163600), False), ((3, 4000 + 77), True), ((2, 400 + 160 * 20), True),
              ((1, 400), True), ((2, 399), True), ((64, 160000), True),
              ((8, 256000), True)]
    for shape, with_reim in shapes:
        x = torch.from_numpy(
            (rng.standard_normal(shape) * 0.3).astype(np.float32)).to(dev)
        before = stft_cuda.log_spectrogram_kernel.launches
        got = stft_cuda.log_spectrogram_kernel(x, with_reim)
        ref = stft_cuda.log_spectrogram_plain(x, True)
        exact = stft_cuda.log_spectrogram_plain(x.double(), True)
        torch.cuda.synchronize()
        F = sp.num_frames(shape[1])
        check(stft_cuda.log_spectrogram_kernel.launches - before == (F > 0),
              f"{shape}: launches")
        if not with_reim:
            got = (got,)
        check(all(g.shape == (shape[0], F, 201) for g in got),
              f"{shape}: output shape")
        if F == 0:
            say(f"[3 kernel] {shape} F=0: empty outputs, no launch")
            continue
        k_err = (got[0].double() - exact[0]).abs()
        p_err = (ref[0].double() - exact[0]).abs()
        lm_err = k_err.max().item()
        check(lm_err <= LM_ATOL, f"{shape}: log-magnitude err {lm_err} "
              "against float64")
        kernel_errs[shape] = lm_err
        diff = (got[0] - ref[0]).abs()
        off = diff > LM_ATOL
        check(bool((p_err[off] > k_err[off]).all()),
              f"{shape}: log-magnitude differs from the float32 plain "
              "version by more than the bar where the kernel is the "
              "farther from float64")
        msg = (f"[3 kernel] {shape} F={F}: max |d logmag| against float64: "
               f"kernel {lm_err:.3g}, float32 plain {p_err.max().item():.3g};"
               f" kernel against float32 plain {diff.max().item():.3g} "
               f"({int(off.sum())} bins beyond {LM_ATOL}")
        if off.any():
            bins = sorted({int(b) for b in off.nonzero()[:, 2].tolist()})
            msg += (f", at bins {bins}, where the float32 plain version "
                    f"misses float64 by {p_err[off].min().item():.3g} to "
                    f"{p_err[off].max().item():.3g} and the kernel by at "
                    f"most {k_err[off].max().item():.3g}")
        msg += ")"
        if with_reim:
            scale = exact[1].abs().max().item()
            k64 = max((g.double() - e).abs().max().item()
                      for g, e in zip(got[1:], exact[1:]))
            p64 = max((r.double() - e).abs().max().item()
                      for r, e in zip(ref[1:], exact[1:]))
            ri_err = max((g - r).abs().max().item()
                         for g, r in zip(got[1:], ref[1:]))
            check(k64 <= REIM_EXACT_RTOL * scale,
                  f"{shape}: re/im err {k64} against float64")
            check(ri_err <= REIM_RTOL * scale, f"{shape}: re/im err {ri_err}")
            msg += (f"; max |d re/im| against float64: kernel {k64:.3g}, "
                    f"float32 plain {p64:.3g}; kernel against float32 plain "
                    f"{ri_err:.3g} (max|re| {scale:.3g})")
        say(msg)
        del x, got, ref, exact, k_err, p_err, diff, off

    # -- 4. timing ---------------------------------------------------------
    # Device time (the host runs ahead behind a sleep kernel), in turns:
    # kernel, torch.stft + log, plain, then the reverse order; warm L2, and
    # cold L2 for the kernel and torch.stft + log.
    window = torch.hann_window(400, periodic=True, device=dev)

    def library(x, with_reim):
        spec = torch.stft(x, n_fft=400, hop_length=160, win_length=400,
                          window=window, center=False, return_complex=True)
        lm = torch.log(spec.abs() + 1e-5)
        return (lm, spec.real, spec.imag) if with_reim else lm

    cycles_per_ms = sleep_cycles_per_ms()
    say(f"[4 timing] sleep kernel: {cycles_per_ms:.0f} cycles per ms")
    timings = {}
    for B, L, with_reim in ((1, 160000, True), (4, 160000, True),
                            (8, 160000, True), (8, 32240, False),
                            (16, 163600, False), (16, 64000, False),
                            (8, 163600, False), (8, 256000, True)):
        x = torch.from_numpy((rng.standard_normal((B, L)) * 0.3)
                             .astype(np.float32)).to(dev)
        F = sp.num_frames(L)
        flops = B * F * SPECTROGRAM_OPS_PER_FRAME
        outs = 3 if with_reim else 1
        nbytes = 4 * (B * L + outs * B * F * 201)  # in once, outs once
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        fns = {"ms": lambda: stft_cuda.log_spectrogram_kernel(x, with_reim),
               "library_ms": lambda: library(x, with_reim),
               "plain_ms": lambda: stft_cuda.log_spectrogram_plain(x, with_reim)}
        runs = {k: [] for k in fns}
        for key in (*fns, *reversed(list(fns))):
            runs[key].append(device_ms(fns[key], cycles_per_ms))
        t = {k: float(np.mean([ms for ms, _ in v])) for k, v in runs.items()}
        ahead = {k: all(a for _, a in v) for k, v in runs.items()}
        t.update(
            cold_ms=device_ms(fns["ms"], cycles_per_ms, cold=True)[0],
            cold_library_ms=device_ms(fns["library_ms"], cycles_per_ms,
                                      cold=True)[0],
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        timings[(B, L, with_reim)] = t
        check(ahead["ms"] and ahead["library_ms"],
              f"[{B}, {L}]: the host did not run ahead of the device")
        passes = {k: ", ".join(f"{ms:.4f}" for ms, _ in v)
                  for k, v in runs.items()}
        plain_note = "" if ahead["plain_ms"] else (
            " (paced by the host: it copies its bases from host memory "
            "each call)")
        say(f"[4 timing] [{B}, {L}] {'with re/im' if with_reim else 'log-only'}"
            f" (F={F}), device time, warm L2: kernel {t['ms']:.4f} ms "
            f"({passes['ms']}), torch.stft+log {t['library_ms']:.4f} ms "
            f"({passes['library_ms']}), plain {t['plain_ms']:.4f} ms"
            f"{plain_note}; cold L2: kernel {t['cold_ms']:.4f} ms, torch.stft+log "
            f"{t['cold_library_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP "
            f"by FFT), kernel at {100 * t['bound_ms'] / t['ms']:.1f} % of it"
            f" on {smi}")

    # -- 5. end to end, denoiser ---------------------------------------------
    rng = np.random.default_rng(5)
    seconds = (1.3, 3.1, 10.0)
    mixed = [utterance(rng, s, 150 + 40 * i) for i, s in enumerate(seconds)]
    pos = rng.standard_normal(int(0.8 * SR)) * 600
    neg = rng.standard_normal(3 * SR) * 2000
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    den = load_enhancer(Config.denoiser(), DENOISER_NPZ, device="cuda")

    stft_cuda.log_spectrogram_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = den.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    wall_first = time.perf_counter() - t0
    serving_launches = stft_cuda.log_spectrogram_kernel.launches
    say(f"[5 denoiser] main path: {serving_launches} kernel launches "
        "(contexts [8, 32240] and mixed [4, 160000])")
    check(serving_launches == 2,
          f"expected 2 kernel launches, saw {serving_launches}")
    for i, s in enumerate(seconds):
        n = den.cfg.audio.trim_to_whole_frames(len(mixed[i]))
        for key in ("denoised", "mixed_processed", "removed"):
            check(len(out[key][i]) == n, f"{key}[{i}] length")
            check(np.isfinite(out[key][i]).all(), f"{key}[{i}] finite")
    check(np.isfinite(out["snr_est"]).all(), "snr_est finite")
    # the Enhancer turns TF32 off for its own device work only
    check((torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32) == tf32,
          "serving changed the process's TF32 settings")

    t0 = time.perf_counter()
    den.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    wall_warm = time.perf_counter() - t0
    audio = sum(seconds)
    say(f"  batch of {len(seconds)} ({audio:.1f} s of audio): first call "
        f"{wall_first:.3f} s (RTF {audio / wall_first:.1f}x), warm call "
        f"{wall_warm:.3f} s (RTF {audio / wall_warm:.1f}x, "
        f"{wall_warm / len(seconds):.3f} s per utterance) on {smi}")
    for i in range(len(seconds)):
        t0 = time.perf_counter()
        den.enhance(mixed[i], pos, neg)
        w = time.perf_counter() - t0
        say(f"  single {seconds[i]} s utterance: {w:.3f} s "
            f"(RTF {seconds[i] / w:.1f}x) on {smi}")

    with plain_spectrogram(stft_cuda):
        den._ctx_cache.clear()
        ref = den.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    den._ctx_cache.clear()
    for i in range(len(seconds)):
        compare({k: v[i] for k, v in out.items()},
                {k: v[i] for k, v in ref.items()},
                f"kernel vs plain spectrogram, utterance {i}")

    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    g_in = golden_inputs()
    check(str(golden["input_sha256"]) == input_digest(*g_in),
          "golden inputs do not regenerate (numpy stream changed?)")
    compare(den.enhance(*g_in), golden, "golden (JAX package, CPU)",
            keys=("denoised", "mixed_processed"))

    long = utterance(rng, 40.0, 170)
    t0 = time.perf_counter()
    seg = den.enhance_long(long, pos, neg, segment_seconds=8)
    w_seg = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = den.enhance(long, pos, neg)
    w_whole = time.perf_counter() - t0
    # The 40 s input fills its bucket exactly, so the unsegmented call's
    # last 17 windows read the zero padding of the log-magnitude, while
    # the last segment sits on a longer bucket and reads frames of zero
    # audio, log(1e-5).  The JAX package's two paths differ the same way
    # there (tests/test_torch_enhance.py), so the check covers the frames
    # before that tail and the tail's difference is printed.
    head = 160 * (sp.num_frames(len(long)) - 17)
    errs = {}
    for key in ("denoised", "mixed_processed", "removed"):
        check(len(seg[key]) == len(whole[key]), f"enhance_long {key} length")
        errs[key] = float(np.abs(seg[key][:head] - whole[key][:head]).max())
        check(errs[key] <= WAVE_ATOL, f"enhance_long {key}: max |diff| "
              f"{errs[key]:.3g} > {WAVE_ATOL} before the last 17 frames")
    tail = float(np.abs(seg["denoised"][head:] - whole["denoised"][head:]).max())
    say("  enhance_long (8 s segments) vs unsegmented 40 s, before the last "
        "17 frames: max |diff| " + ", ".join(f"{k} {v:.3g}" for k, v in
                                            errs.items())
        + f"; last 17 frames (bucket tail) denoised {tail:.3g}")
    say(f"  40 s: segmented {w_seg:.3f} s (RTF {40 / w_seg:.1f}x), "
        f"unsegmented {w_whole:.3f} s (RTF {40 / w_whole:.1f}x) on {smi}")
    # 39.3 s leaves 70 frames of zero audio in its 40 s bucket, so both
    # paths read the same frames at the tail: they agree everywhere
    short = utterance(rng, 39.3, 190)
    seg = den.enhance_long(short, pos, neg, segment_seconds=8)
    whole = den.enhance(short, pos, neg)
    compare(seg, whole, "enhance_long (8 s segments) vs unsegmented 39.3 s, "
            "whole waveform")

    # -- 6. end to end, separator --------------------------------------------
    sep = load_enhancer(Config.separator(), SEPARATOR_NPZ, device="cuda")
    target = utterance(rng, 3.0, 210)
    interference = utterance(rng, 3.0, 120)
    mix_sep = target + 0.8 * np.roll(interference, 4000)
    stft_cuda.log_spectrogram_kernel.launches = 0
    t0 = time.perf_counter()
    # the separator's slots: (interference speaker, target speaker)
    res = sep.enhance(mix_sep, interference, target)
    w = time.perf_counter() - t0
    check(stft_cuda.log_spectrogram_kernel.launches == 2, "separator launches")
    check(len(res["denoised"]) == sep.cfg.audio.trim_to_whole_frames(
        len(mix_sep)), "separator length")
    check(all(np.isfinite(res[k]).all() for k in ("denoised", "removed")),
          "separator output finite")
    say(f"[6 separator] 3.0 s: {w:.3f} s, snr_est {float(res['snr_est']):.4f}, "
        f"2 kernel launches, on {smi}")

    # -- 7. command line -------------------------------------------------------
    from scipy.io import wavfile
    with tempfile.TemporaryDirectory() as tmp:
        wavfile.write(os.path.join(tmp, "in.wav"), SR,
                      np.rint(mixed[1]).astype(np.int16))
        wavfile.write(os.path.join(tmp, "neg.wav"), SR,
                      np.rint(neg).astype(np.int16))
        out_wav = os.path.join(tmp, "out.wav")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "nhans_tpu_torch.cli.denoiser",
             "--checkpoint", DENOISER_NPZ, "--input",
             os.path.join(tmp, "in.wav"), "--neg",
             os.path.join(tmp, "neg.wav"), "--pos", "", "--output", out_wav],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        w = time.perf_counter() - t0
        check(r.returncode == 0, f"denoiser CLI failed:\n{r.stderr}")
        snr_cli = float(next(line for line in r.stdout.splitlines()
                             if line and "->" not in line
                             and not line.startswith("NOTE")))
        want = den.enhance(mixed[1], np.zeros(SR), neg)
        check(abs(snr_cli - float(want["snr_est"]))
              <= SNR_RTOL * abs(float(want["snr_est"])), "CLI snr_est")
        for tag in ("", "_mixed_processed", "_removed", "_compensated"):
            rate, x = wavfile.read(os.path.join(tmp, f"out{tag}.wav"))
            check(rate == SR and x.dtype == np.float32, f"out{tag}.wav format")
            check(len(x) == len(want["denoised"]) and np.isfinite(x).all(),
                  f"out{tag}.wav length / finite")
        wav = wavfile.read(out_wav)[1]
        check(np.abs(wav - want["denoised"]).max() <= WAVE_ATOL, "CLI output")
    say(f"[7 cli] python -m nhans_tpu_torch.cli.denoiser: 4 files, snr_est "
        f"{snr_cli:.4f}, {w:.1f} s with start-up")

    # -- 8. training: one full-width step against the JAX package ----------
    with np.load(GOLDEN_TRAIN) as z:
        tgold = {k: z[k] for k in z.files}
    check(str(tgold["input_sha256"]) == input_digest(
        *golden_train_inputs().values()), "training golden inputs")
    got = port_train_golden("cuda", tgold)
    say("[8 train golden] " + step_errors(got, tgold, "golden step"))

    # -- 9. training through the command line, full width -------------------
    from torch.utils.flop_counter import FlopCounterMode

    from nhans_tpu_torch.cli import train as cli_train
    from nhans_tpu_torch.data.banks import BankIndexLoader, DeviceBanks
    from nhans_tpu_torch.models import init_variables
    from nhans_tpu_torch.train.step import make_train_step, step_generator

    tmp = tempfile.mkdtemp(prefix="nhans_chip_smoke_")
    try:
        corpus = write_corpus(tmp, np.random.default_rng(9))

        def train(name, *flags):
            """cli.train with this corpus, monitored at every step;
            (trainer, kernel launches, and from the metrics record by step:
            losses, device ms by the trainer's CUDA events, input-wait
            shares)."""
            args = ["--speech_wav_dir", corpus[0], "--noise_wav_dir",
                    corpus[1], "--checkpoint_dir", f"{tmp}/ck_{name}",
                    "--summaries_dir", f"{tmp}/sum_{name}", "--eval_utts",
                    "0", "--train_monitor_every", "1", *flags]
            trainer = cli_train.build_trainer(args)
            first = trainer.tstep
            torch.cuda.synchronize()
            stft_cuda.log_spectrogram_kernel.launches = 0
            trainer.train()
            torch.cuda.synchronize()
            launches = stft_cuda.log_spectrogram_kernel.launches
            check(launches == 4 * (trainer.tstep - first),
                  f"{name}: {launches} kernel launches in "
                  f"{trainer.tstep - first} steps, expected 4 a step")
            with open(f"{tmp}/sum_{name}/nhans.jsonl") as f:
                # monitor records; each save also wrote an all-zero
                # evaluation record (--eval_utts 0), without a loss
                records = {r["step"]: r for r in map(json.loads, f)
                           if "loss" in r}
            losses = {k: r["loss"] for k, r in records.items()}
            check(all(np.isfinite(v) for v in losses.values()),
                  f"{name}: losses finite")
            ms = [r["step_device_ms"] for _, r in sorted(records.items())]
            waits = [r["input_wait_frac"] for _, r in sorted(records.items())]
            return trainer, launches, ms, losses, waits

        def moved(trainer, before):
            """Parameters and BatchNorm statistics left their init."""
            state = trainer.model.state_dict()
            for key in ("resblock1.conv1.w", "embedding.block1.conv1.w",
                        "last_dense.w", "resblock1.bn1.pop_mean",
                        "embedding.block1.bn1.pop_variance"):
                check(not torch.equal(state[key].cpu(), before[key]),
                      f"{key} did not move")

        # denoiser, banked: 8 steps timed, checkpoints at 4 and 8
        torch.cuda.reset_peak_memory_stats()
        trainer, launches, ms, losses, _ = train(
            "banked", "--batches", "8", "--eval_every", "4")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        seeded = torch.Generator()
        seeded.manual_seed(trainer.cfg.data.seed)
        init = init_variables(trainer.cfg, seeded, "cpu").state_dict()
        moved(trainer, init)
        check(trainer.ckpt.steps() == [4, 8], "checkpoints at steps 4 and 8")
        banked_losses = losses  # phase 15 (c) resumes against them
        warm = ms[2:]
        step_ms = float(np.median(warm))
        # FLOPs of one step (forward and backward), counted by torch on the
        # same banked step with a fresh generator
        dbanks = DeviceBanks(trainer.cfg, dev)
        idx = {k: torch.from_numpy(v).to(dev) for k, v in
               next(BankIndexLoader(dbanks, trainer.batch_utts)).items()}
        with FlopCounterMode(display=False) as counter:
            trainer.step_fn(trainer.state, dbanks.banks, idx,
                            step_generator(0, 0))
        flops = counter.get_total_flops()
        del dbanks
        say(f"[9 train] denoiser banked, full width, {trainer.batch_utts} "
            f"utterances x {trainer.cfg.data.slices_per_step} crops: losses "
            + ", ".join(f"{v:.4f}" for _, v in sorted(losses.items()))
            + f"; {launches} kernel launches in 8 steps; per step "
            + ", ".join(f"{v:.1f}" for v in ms) + " ms (CUDA events, from "
            "fetching the batch to the step's last kernel); warm "
            f"median {step_ms:.1f} ms, {flops / 1e12:.3f} TFLOP a step, "
            f"{flops / step_ms / 1e9:.2f} TFLOP/s; peak memory "
            f"{peak_gb:.2f} GiB; on {smi}")
        banked_launches = launches

        # auto-resume: 4 steps and a checkpoint, then a new trainer on the
        # same directory takes step 5 as the uninterrupted run did.  Its
        # later steps drift apart at the rate two uninterrupted runs do:
        # cuDNN's backward sums in a different order from run to run (the
        # reference's default sgd keeps that drift linear; Adam's first
        # steps turn it into lr-sized sign flips of near-zero gradients)
        train("resume", "--batches", "4", "--eval_every", "4")
        trainer2, _, _, resumed, _ = train("resume", "--batches", "6",
                                           "--eval_every", "4")
        rel = abs(resumed[5] - losses[5]) / abs(losses[5])
        check(rel <= RESUME_RTOL, f"resumed step 5: loss {resumed[5]} "
              f"against {losses[5]}")
        say("  auto-resume from step 4: losses of steps 1-6 "
            + ", ".join(f"{resumed[k]:.7f}" for k in sorted(resumed))
            + " against " + ", ".join(f"{losses[k]:.7f}"
                                      for k in sorted(resumed))
            + f" uninterrupted; step 5 rel diff {rel:.2g}")
        del trainer, trainer2

        # denoiser, streaming from the host
        trainer, launches, ms, losses, waits = train(
            "stream", "--device_corpus", "off", "--batches", "6",
            "--eval_every", "6")
        check(not trainer.banked, "streaming run is not banked")
        moved(trainer, init)
        say(f"[9 train] denoiser streaming: losses "
            + ", ".join(f"{v:.4f}" for _, v in sorted(losses.items()))
            + f"; {launches} kernel launches in 6 steps; per step "
            + ", ".join(f"{v:.1f}" for v in ms) + " ms (CUDA events, "
            f"input wait included), warm median {np.median(ms[2:]):.1f} ms; "
            "input wait share per step "
            + ", ".join(f"{v:.3f}" for v in waits)
            + f"; on {smi}")
        del trainer

        # separator, banked
        trainer, launches, _, losses, _ = train(
            "separator", "--task", "separator", "--batches", "3",
            "--eval_every", "3")
        check(trainer.banked, "separator run is banked")
        moved(trainer, init)  # the same seeded init as the denoiser
        say(f"[9 train] separator banked: losses "
            + ", ".join(f"{v:.4f}" for _, v in sorted(losses.items()))
            + f"; {launches} kernel launches in 3 steps")
        del trainer

        # -- 10. evaluation ------------------------------------------------------
        from nhans_tpu_torch.cli import evaluate as cli_evaluate
        from nhans_tpu_torch.compat.weights import load_npz
        from nhans_tpu_torch.data.loader import EvalLoader
        from nhans_tpu_torch.models import build_model
        from nhans_tpu_torch.tools import eval_checkpoints
        from nhans_tpu_torch.train.evaluate import Evaluator

        # against the JAX package's evaluation of two 2.5 s utterances (CPU)
        with np.load(GOLDEN_EVAL) as z:
            egold = {k: z[k] for k in z.files}
        check(str(egold["input_sha256"]) == eval_digest(
            golden_eval_examples()), "evaluation golden inputs")
        got = port_eval_golden("cuda")
        compare_metrics(
            {k: v for k, v in got.items() if not k.startswith("denoised_")},
            {k: v for k, v in egold.items()
             if k.startswith(("metric/", "utt/"))},
            "[10 eval] golden (JAX package, CPU), metrics and per-utterance "
            "scores")
        errs = [float(np.abs(got[f"denoised_{i}"]
                             - egold[f"denoised_{i}"]).max()) for i in range(2)]
        check(max(errs) <= WAVE_ATOL, f"golden eval denoised: {errs}")
        say(f"  golden eval denoised waveforms: max |diff| {max(errs):.3g}")

        # full width: the corpus's 8 valid utterances, one group of 8 on the
        # 16 s bucket ([8, 256000]), with the kernel and with the plain
        # spectrogram
        nwin = 8 * (sp.num_frames(256000) - 200)

        def full_width(task, npz):
            base = getattr(Config, task)()
            cfg = base.replace(data=dataclasses.replace(
                base.data, speech_wav_dir=corpus[0],
                noise_wav_dir=corpus[1]))
            model = build_model(cfg)
            model.load_state_dict(load_npz(npz))
            evaluator = Evaluator(cfg, model.to(dev))
            examples = list(EvalLoader(cfg))
            check(len(examples) == 8, f"{task}: 8 valid utterances")
            # FLOPs of the group: every window of the bucket and 16
            # contexts, counted by torch on the card
            with torch.inference_mode():
                ctx = torch.zeros(1, 200, 201, device=dev)
                with FlopCounterMode(display=False) as fc:
                    ea, eb = evaluator.model(None, ctx, ctx)
                per_ctx = fc.get_total_flops() / 2
                with FlopCounterMode(display=False) as fc:
                    evaluator.model(torch.zeros(16, 35, 201, device=dev),
                                    emb_a=ea.expand(16, -1),
                                    emb_b=eb.expand(16, -1))
                per_win = fc.get_total_flops() / 16
            flops = nwin * per_win + 16 * per_ctx
            runs = {}
            for mode in ("kernel", "plain"):
                dump = f"{tmp}/eval_{task}_{mode}"
                log = timed_groups(evaluator)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                stft_cuda.log_spectrogram_kernel.launches = 0
                t0 = time.perf_counter()
                if mode == "plain":
                    with plain_spectrogram(stft_cuda):
                        metrics = evaluator.run(None, examples, modelname=task,
                                                dump_results=dump,
                                                return_metrics=True)
                else:
                    metrics = evaluator.run(None, examples, modelname=task,
                                            dump_results=dump,
                                            return_metrics=True)
                wall = time.perf_counter() - t0
                launches = stft_cuda.log_spectrogram_kernel.launches
                peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
                del evaluator._forward
                check(len(log) == 1, f"{task} {mode}: one group")
                check(all(np.isfinite(v) for v in metrics.values()),
                      f"{task} {mode}: metrics finite")
                check({"stoi", "estoi", "pesq"} <= set(metrics),
                      f"{task} {mode}: STOI, ESTOI and PESQ reported")
                if task == "separator":
                    check({"si_sdr_interferer", "confused_utts"}
                          <= set(metrics), "separator confusion metrics")
                card_ms, fwd_s = log[0]
                say(f"[10 eval] {task} full width, {mode} spectrogram: "
                    + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
                    + f"; one group [8, 256000], {nwin} windows "
                    f"({per_win / 1e9:.3f} GFLOP each) and 16 contexts, "
                    f"{flops / 1e12:.1f} TFLOP: card {card_ms:.1f} ms by CUDA "
                    f"events ({flops / card_ms / 1e9:.2f} TFLOP/s), host "
                    f"scoring {wall - fwd_s:.2f} s, run {wall:.2f} s; peak "
                    f"memory {peak_gb:.2f} GiB; {launches} kernel launches; "
                    f"on {smi}")
                runs[mode] = (metrics, dump, launches)
            check(runs["kernel"][2] == 4,
                  f"{task}: {runs['kernel'][2]} kernel launches, expected 4")
            compare_metrics(runs["kernel"][0], runs["plain"][0],
                            f"{task}: kernel vs plain spectrogram, metrics")
            compare_dumps(runs["kernel"][1], runs["plain"][1],
                          f"{task}: kernel vs plain spectrogram")
            return runs["kernel"][2]

        eval_launches = full_width("denoiser", DENOISER_NPZ)
        full_width("separator", SEPARATOR_NPZ)

        # the trainer scores its step-2 checkpoint in the loop and on a
        # thread (overlapping step 3); cli.evaluate and eval_checkpoints
        # rescore it
        def train_eval(name, *flags):
            args = ["--speech_wav_dir", corpus[0], "--noise_wav_dir",
                    corpus[1], "--checkpoint_dir", f"{tmp}/ck_{name}",
                    "--summaries_dir", f"{tmp}/sum_{name}", "--eval_utts",
                    "4", "--wav_dump_folder", "", "--dump_results", "",
                    "--batches", "3", "--eval_every", "2",
                    "--no-eval_after_training", "--train_monitor_every",
                    "1", *flags]
            trainer = cli_train.build_trainer(args)
            torch.cuda.synchronize()
            stft_cuda.log_spectrogram_kernel.launches = 0
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = stft_cuda.log_spectrogram_kernel.launches
            check(launches == 4 * 3 + 4, f"{name}: {launches} kernel "
                  "launches, expected 4 a step and 4 for the evaluation")
            check(trainer._eval_thread is None, f"{name}: eval joined")
            with open(f"{tmp}/sum_{name}/nhans.jsonl") as f:
                evals = [r for r in map(json.loads, f) if "eval_loss" in r]
            check([r["step"] for r in evals] == [2],
                  f"{name}: one evaluation record, at step 2")
            return ({k: v for k, v in evals[0].items()
                     if k not in ("step", "time")}, wall)

        sync_rec, w_sync = train_eval("eval_sync")
        async_rec, w_async = train_eval("eval_async", "--async_eval")
        say(f"[10 eval] trainer, 3 steps with the step-2 checkpoint scored on "
            f"4 utterances: synchronous {w_sync:.2f} s, --async_eval "
            f"{w_async:.2f} s; record "
            + ", ".join(f"{k} {v:.4f}" for k, v in sync_rec.items()))
        compare_metrics(async_rec, sync_rec,
                        "trainer --async_eval against synchronous, step 2")
        ck_root = f"{tmp}/ck_eval_sync/nhans"
        data = ["--speech_wav_dir", corpus[0], "--noise_wav_dir", corpus[1],
                "--eval_utts", "4"]
        metrics = cli_evaluate.main(["--checkpoint", f"{ck_root}/2",
                                     "--wav_dump_folder", "",
                                     "--dump_results", "", *data])
        compare_metrics(metrics, sync_rec,
                        "cli.evaluate on the step-2 checkpoint against the "
                        "trainer's record")
        swept = eval_checkpoints.main(["--task", "denoiser",
                                       "--checkpoint_root", ck_root,
                                       "--eval_seeds", "valid", *data])
        check([r["step"] for r in swept] == [2], "eval_checkpoints steps")
        compare_metrics({k: v for k, v in swept[0].items() if k != "step"},
                        sync_rec, "tools/eval_checkpoints against the "
                        "trainer's record")

        # -- 11. bfloat16: one full-width step against the JAX package ------
        with np.load(GOLDEN_TRAIN_BF16) as z:
            bgold = {k: z[k] for k in z.files}
        check(str(bgold["input_sha256"]) == input_digest(
            *golden_train_inputs().values()), "bfloat16 golden inputs")
        conv_dtypes = set()

        class ConvDtypes(torch.overrides.TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func is torch.nn.functional.conv2d:
                    conv_dtypes.update(a.dtype for a in args[:3]
                                       if isinstance(a, torch.Tensor))
                return func(*args, **(kwargs or {}))

        with ConvDtypes():
            got = port_train_golden("cuda", bgold, "bfloat16")
        check(conv_dtypes == {torch.bfloat16},
              f"bfloat16 step convolutions ran in {conv_dtypes}")
        errs = {"loss": abs(got["loss"] - float(bgold["loss"]))
                / float(bgold["loss"]),
                "grad_norm": abs(got["grad_norm"] - float(bgold["grad_norm"]))
                / float(bgold["grad_norm"])}
        for path in TRAIN_LAYERS:
            want = bgold[f"delta/{path}"]
            errs[f"delta/{path}"] = float(
                np.abs(got[f"delta/{path}"] - want).max() / np.abs(want).max())
        for path in TRAIN_STATS:
            for name in ("pop_mean", "pop_variance"):
                key = f"stats/{path}/{name}"
                errs[key] = float(np.abs(got[key] - bgold[key]).max())
        for key, err in errs.items():
            bar = (BF16_FIRST_BN_ATOL if key.startswith(
                f"stats/{TRAIN_STATS[0]}/") else BF16_SPREAD_X * max(
                    float(bgold[f"{d}/{key}"])
                    for d in ("gap", "spread", "strict")))
            check(err <= bar, f"bfloat16 golden {key}: {err:.3g} > {bar:.3g}")
        say("[11 bf16 golden] convolutions in bfloat16; loss "
            f"{got['loss']:.6f} (JAX {float(bgold['loss']):.6f}); against "
            "the JAX bfloat16 step (its gap to its float32 step, spread "
            "under a 1e-6 weight perturbation, strict rounding): "
            + ", ".join(f"{k} {v:.3g} (" + ", ".join(
                f"{float(bgold[f'{d}/{k}']):.3g}"
                for d in ("gap", "spread", "strict")) + ")"
                for k, v in errs.items()))

        # -- 12. step time and memory: float32 and bfloat16, sgd and Adam,
        # remat, the padded tower -------------------------------------------
        from nhans_tpu_torch.train.step import (create_state, make_tx,
                                                state_of)

        tbase = Config.denoiser()
        tbase = tbase.replace(data=dataclasses.replace(
            tbase.data, speech_wav_dir=corpus[0], noise_wav_dir=corpus[1]))
        dbanks = DeviceBanks(tbase, dev)
        check(dbanks.decoder == "native", "the native wav decoder did not "
              "build")
        idx_loader = BankIndexLoader(dbanks, 16)
        idxs = [{k: torch.from_numpy(v).to(dev) for k, v in
                 next(idx_loader).items()} for _ in range(STEP_RUNS)]

        def step_run(name, alg="sgd", steps=STEP_RUNS, flops=False, **model):
            """(ms per step by CUDA events after 2 warm steps, peak GiB,
            kernel launches, FLOPs a step or 0, the state's change over
            every step) of full-width banked steps from the seeded init."""
            cfg = tbase.replace(
                model=dataclasses.replace(tbase.model, **model),
                train=dataclasses.replace(tbase.train, alg=alg))
            g = torch.Generator()
            g.manual_seed(0)
            model_, state, tx = create_state(cfg, g, dev)
            init = {k: v.clone() for k, v in model_.state_dict().items()}
            step_fn = make_train_step(cfg, model_, tx, banked=True)
            for i in range(2):
                step_fn(state, dbanks.banks, idxs[i], step_generator(0, i))
            n_flops = 0
            if flops:
                with FlopCounterMode(display=False) as counter:
                    step_fn(state, dbanks.banks, idxs[1],
                            step_generator(0, 1))
                n_flops = counter.get_total_flops()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stft_cuda.log_spectrogram_kernel.launches = 0
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
            ev[0].record()
            for i in range(steps):
                step_fn(state, dbanks.banks, idxs[i], step_generator(0, i))
                ev[i + 1].record()
            torch.cuda.synchronize()
            ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
            launches = stft_cuda.log_spectrogram_kernel.launches
            check(launches == 4 * steps, f"{name}: {launches} kernel "
                  f"launches in {steps} steps")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            change = {k: v - init[k] for k, v in model_.state_dict().items()
                      if v.is_floating_point()}
            return float(np.median(ms)), peak, launches, n_flops, change

        step_times = {}
        for alg in ("sgd", "adam"):
            for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
                name = f"{dtype} {alg}"
                ms, peak, launches, n_flops, _ = step_run(
                    name, alg, flops=name not in step_times,
                    compute_dtype=dtype)
                rec = step_times.setdefault(name, {"ms": [], "flops": n_flops})
                rec["ms"].append(ms)
                rec.update(peak=peak, launches=launches)
        for name, rec in step_times.items():
            peak_flops = (PEAK_BF16_FLOPS if "bfloat16" in name
                          else PEAK_FP32_FLOPS)
            rate = rec["flops"] / np.mean(rec["ms"]) / 1e9
            say(f"[12 step] {name}, full width ({STEP_RUNS} steps x2, "
                f"median ms by CUDA events): "
                + " and ".join(f"{v:.1f}" for v in rec["ms"])
                + f" ms; {rec['flops'] / 1e12:.3f} TFLOP a step, "
                f"{rate:.2f} TFLOP/s, {100 * rate * 1e12 / peak_flops:.2f} % "
                f"of {peak_flops / 1e12:.0f} TFLOP/s; peak memory "
                f"{rec['peak']:.2f} GiB; {rec['launches']} kernel launches; "
                f"on {smi}")

        def worst_update(got_, want_, skip=()):
            """The largest max |diff| over max |delta| of any tensor but
            ``skip``, the largest max |diff| of any population statistic,
            and the tensor of the first."""
            upd, stats, at = 0.0, 0.0, "none"
            for key, want in want_.items():
                if key.endswith(skip):
                    continue
                diff = float((got_[key] - want).abs().max())
                if "pop_" in key:
                    stats = max(stats, diff)
                elif diff / max(float(want.abs().max()), 1e-30) > upd:
                    upd = diff / max(float(want.abs().max()), 1e-30)
                    at = key
            return upd, stats, at

        # remat, timed and measured from the seeded init over 8 steps
        runs = {}
        for remat in (False, True, True, False):
            ms, peak, _, _, change = step_run(f"remat={remat}", remat=remat)
            runs.setdefault(remat, dict(ms=[], peak=peak, change=[]))
            runs[remat]["ms"].append(ms)
            runs[remat]["change"].append(change)
        a, b = runs[False], runs[True]
        floor8 = worst_update(a["change"][1], a["change"][0], NOISE_BIASES)
        remat8 = worst_update(b["change"][0], a["change"][0], NOISE_BIASES)
        del runs

        # remat against the plain step: one full-width step from the
        # shipped weights, where every layer's gradient is live (the
        # seeded init zeroes last_dense, the Inject projections and the
        # positional MLPs' last layers, so one step from it moves nothing
        # below last_dense), with cuDNN's deterministic algorithms: the
        # plain step twice (their difference is the floor), then remat
        def shipped_step(remat):
            cfg = tbase.replace(model=dataclasses.replace(tbase.model,
                                                          remat=remat))
            model_ = build_model(cfg)
            model_.load_state_dict(load_npz(DENOISER_NPZ))
            model_.to(dev)
            tx = make_tx(cfg)
            state = state_of(model_, tx)
            init = {k: v.clone() for k, v in model_.state_dict().items()
                    if v.is_floating_point()}
            step_fn = make_train_step(cfg, model_, tx, banked=True)
            loss = float(step_fn(state, dbanks.banks, idxs[0],
                                 step_generator(0, 0))["loss"])
            return loss, {k: v - init[k] for k, v in
                          model_.state_dict().items() if k in init}

        torch.backends.cudnn.deterministic = True
        try:
            (l0, c0), (l1, c1), (lr_, cr) = (
                shipped_step(False), shipped_step(False), shipped_step(True))
        finally:
            torch.backends.cudnn.deterministic = False
        # every layer moves but the positional MLPs, which see a single
        # position where a block's stride leaves one (their BatchNorms then
        # output a constant and pass no gradient), and the noise biases
        live = [k for k, v in c0.items() if "pop_" not in k
                and v.abs().max() > 0]
        dead = [k for k, v in c0.items() if "pop_" not in k
                and k not in live and not k.endswith(NOISE_BIASES)
                and ".temb." not in k and ".femb." not in k]
        check(not dead, f"remat: updates with no gradient: {dead}")
        floor1 = worst_update(c1, c0)
        rel = abs(lr_ - l0) / l0
        check(rel <= RESUME_RTOL, f"remat loss: rel {rel}")
        worst = {"update": 0.0, "statistics": 0.0}
        for key, want in c0.items():
            got_ = cr[key]
            if "pop_" in key:
                check(torch.allclose(got_, want, atol=1e-4, rtol=1e-3),
                      f"remat statistics {key}")
                worst["statistics"] = max(worst["statistics"], float(
                    (got_ - want).abs().max()))
            else:
                err = float((got_ - want).abs().max()
                            / max(float(want.abs().max()), 1e-30))
                check(err <= TRAIN_DELTA_RTOL, f"remat update {key}: {err}")
                worst["update"] = max(worst["update"], err)
        n_compared = len(c0)
        del c0, c1, cr
        say(f"[12 remat] float32 sgd, one step from the shipped weights "
            f"with cuDNN deterministic, all {n_compared} tensors "
            f"compared ({len(live)} updates live): loss rel diff {rel:.2g}, updates within "
            f"{worst['update']:.3g} of their largest |delta|, statistics "
            f"within {worst['statistics']:.3g} (plain against plain: "
            f"{floor1[0]:.3g}, {floor1[1]:.3g}). After 8 steps from the "
            f"seeded init, cuDNN free to choose: plain against plain "
            f"{floor8[0]:.3g} ({floor8[2]}), {floor8[1]:.3g}; remat against "
            f"plain {remat8[0]:.3g} ({remat8[2]}), {remat8[1]:.3g}. Step "
            + " and ".join(f"{v:.1f}" for v in a["ms"])
            + f" ms, peak {a['peak']:.2f} GiB without; "
            + " and ".join(f"{v:.1f}" for v in b["ms"])
            + f" ms, peak {b['peak']:.2f} GiB with --remat; on {smi}")

        # the padded tower's step against the native geometry
        pad_ms = {}
        for pad in (0, FREQ_PAD, FREQ_PAD, 0):
            ms, peak, _, _, _ = step_run(f"freq_pad_to={pad}",
                                            freq_pad_to=pad)
            pad_ms.setdefault(pad, []).append(ms)
        say(f"[12 freq_pad] float32 sgd step: native "
            + " and ".join(f"{v:.1f}" for v in pad_ms[0])
            + f" ms, --freq_pad_to {FREQ_PAD} "
            + " and ".join(f"{v:.1f}" for v in pad_ms[FREQ_PAD])
            + f" ms; on {smi}")
        del dbanks

        # -- 13. serving with NHANS_FREQ_PAD=256 --------------------------------
        pcfg = Config.denoiser()
        pden = load_enhancer(pcfg.replace(model=dataclasses.replace(
            pcfg.model, freq_pad_to=FREQ_PAD)), DENOISER_NPZ, device="cuda")
        padded = pden.enhance_batch(mixed, [pos] * 3, [neg] * 3)
        for i in range(len(seconds)):
            compare({k: v[i] for k, v in padded.items()},
                    {k: v[i] for k, v in out.items()},
                    f"[13 serving] NHANS_FREQ_PAD={FREQ_PAD} vs native, "
                    f"utterance {i}")
        walls = {0: [], FREQ_PAD: []}
        for enh, pad in ((den, 0), (pden, FREQ_PAD), (pden, FREQ_PAD),
                         (den, 0)):
            enh._ctx_cache.clear()
            enh.enhance_batch(mixed, [pos] * 3, [neg] * 3)  # contexts cached
            t0 = time.perf_counter()
            enh.enhance_batch(mixed, [pos] * 3, [neg] * 3)
            walls[pad].append(time.perf_counter() - t0)
        say(f"  warm batch of {len(seconds)} ({audio:.1f} s of audio): native "
            + " and ".join(f"{w:.3f} s (RTF {audio / w:.1f}x)"
                           for w in walls[0])
            + f", padded " + " and ".join(f"{w:.3f} s (RTF {audio / w:.1f}x)"
                                          for w in walls[FREQ_PAD])
            + f"; on {smi}")
        with tempfile.TemporaryDirectory() as ptmp:
            wavfile.write(os.path.join(ptmp, "in.wav"), SR,
                          np.rint(mixed[1]).astype(np.int16))
            wavfile.write(os.path.join(ptmp, "neg.wav"), SR,
                          np.rint(neg).astype(np.int16))
            r = subprocess.run(
                [sys.executable, "-m", "nhans_tpu_torch.cli.denoiser",
                 "--checkpoint", DENOISER_NPZ, "--input",
                 os.path.join(ptmp, "in.wav"), "--neg",
                 os.path.join(ptmp, "neg.wav"), "--pos", "", "--output",
                 os.path.join(ptmp, "out.wav")], cwd=REPO,
                capture_output=True, text=True, timeout=600,
                env=dict(os.environ, NHANS_FREQ_PAD=str(FREQ_PAD)))
            check(r.returncode == 0, f"padded denoiser CLI failed:\n{r.stderr}")
            want = den.enhance(mixed[1], np.zeros(SR), neg)
            wav = wavfile.read(os.path.join(ptmp, "out.wav"))[1]
            err = float(np.abs(wav - want["denoised"]).max())
            check(err <= WAVE_ATOL, f"padded CLI output: {err}")
        say(f"  python -m nhans_tpu_torch.cli.denoiser with NHANS_FREQ_PAD="
            f"{FREQ_PAD}: max |diff| {err:.3g} from the native Enhancer")
        del pden

        # -- 14. cli.train with every option --------------------------------------
        prof = f"{tmp}/profile"
        stft_cuda.log_spectrogram_kernel.launches = 0
        args = ["--speech_wav_dir", corpus[0], "--noise_wav_dir", corpus[1],
                "--checkpoint_dir", f"{tmp}/ck_options", "--summaries_dir",
                f"{tmp}/sum_options", "--dtype", "bfloat16", "--remat",
                "--profile_dir", prof, "--batches", "21", "--eval_utts", "2",
                "--wav_dump_folder", "", "--dump_results", "",
                "--train_monitor_every", "1"]
        trainer = cli_train.build_trainer(args)
        torch.cuda.synchronize()
        stft_cuda.log_spectrogram_kernel.launches = 0
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(trainer.decoder == "native", f"cli.train decoded with "
              f"{trainer.decoder}, not the native binding")
        check(trainer.evaluator.model.last_dense.dtype == torch.bfloat16,
              "the checkpoint was not scored in bfloat16")
        launches = stft_cuda.log_spectrogram_kernel.launches
        check(launches == 4 * 21 + 4, f"options run: {launches} launches")
        bf16_launches = launches - 4  # the 21 steps, not the evaluation
        with open(trainer.trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernel_events = [e for e in events
                         if "log_spectrogram_fft" in e.get("name", "")
                         and e.get("cat") == "kernel"]
        check(len(kernel_events) == 40, f"trace: {len(kernel_events)} "
              "spectrogram kernel launches in steps 10 to 19, expected 40")
        with open(f"{tmp}/sum_options/nhans.jsonl") as f:
            recs = [json.loads(line) for line in f]
        evals = [r for r in recs if "eval_loss" in r]
        check(len(evals) == 1 and all(np.isfinite(v) for k, v in
                                      evals[0].items() if k != "time"),
              "options run: one finite evaluation record")
        losses = [r["loss"] for r in recs if "loss" in r]
        check(len(losses) == 21 and np.all(np.isfinite(losses)),
              "options run: 21 finite losses")
        say(f"[14 cli options] --dtype bfloat16 --remat --profile_dir: 21 "
            f"steps and a bfloat16 evaluation in {wall:.1f} s, decoder "
            f"{trainer.decoder}; trace {os.path.basename(trainer.trace_path)}"
            f" with {len(kernel_events)} launches of log_spectrogram_fft "
            f"(of {len(events)} events); eval "
            + ", ".join(f"{k} {v:.4f}" for k, v in evals[0].items()
                        if k not in ("step", "time"))
            + f"; on {smi}")
        del trainer

        # -- 15. several ranks -------------------------------------------------
        p15 = phase15(tmp, corpus, smi, count, tgold, banked_losses,
                      (den, mixed, pos, neg, out))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- result ------------------------------------------------------------------
    kernels = []
    for path, key, n, shapes in (
            ("serving", (4, 160000, True), serving_launches,
             [(8, 32240), (4, 160000)]),
            ("training", (16, 163600, False), banked_launches,
             [(16, 163600), (16, 64000)]),
            ("training, bfloat16", (16, 163600, False), bf16_launches,
             [(16, 163600)]),
            ("evaluation", (8, 256000, True), eval_launches,
             [(8, 256000)]),
            ("training, data-parallel rank", (8, 163600, False),
             p15["launches"], [(8, 163600)])):
        t = timings[key]
        kernels.append({
            "name": f"log_spectrogram ({path})",
            "route": "cuda",
            "source": "nhans_tpu_torch/csrc/log_spectrogram.cu",
            "replaces": "nhans_tpu/ops/stft_pallas.py:36",
            "launches": n,
            "max_abs_err": max(kernel_errs[s] for s in shapes),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": list(key[:2]), "with_reim": key[2]})
        if path == "training, data-parallel rank":
            kernels[-1]["note"] = (
                f"launches: rank 0's in phase 15 (b), {1 + STEPS_DP} banked "
                f"steps of {p15['rows']} utterances a rank over gloo, both "
                f"ranks on this card (rank 1: {p15['launches_rank1']}); "
                "times: phase 4 at the rank's shape")
        if path == "training, bfloat16":
            kernels[-1]["note"] = (
                "launches: the 21 steps of cli.train --dtype bfloat16 "
                "(phase 14); times: phase 4 at the same shape, as the "
                "kernel is float32 in every compute dtype")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


def main_cards() -> int:
    """``--cards``: phase 15 (f) alone, for a machine with two cards or
    more: the data-parallel step over NCCL on two cards against the
    1-rank step and the data-parallel golden, and --mesh auto serving
    against the 1-card Enhancer.  Its last line is the result line."""
    import torch

    if torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs two CUDA cards or more",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from nhans_tpu_torch.cli._app import load_enhancer
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.ops import _build
    from tests.make_torch_golden import DENOISER_NPZ

    t_start = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    say(f"[cards] {kind} x{count}; nvidia-smi: {'; '.join(smi)}")
    _build.load("log_spectrogram")
    rng = np.random.default_rng(5)  # phase 5's inputs
    seconds = (1.3, 3.1, 10.0)
    mixed = [utterance(rng, s, 150 + 40 * i) for i, s in enumerate(seconds)]
    pos = rng.standard_normal(int(0.8 * SR)) * 600
    neg = rng.standard_normal(3 * SR) * 2000
    den = load_enhancer(Config.denoiser(), DENOISER_NPZ, device="cuda")
    served = (den, mixed, pos, neg, None)
    tmp = tempfile.mkdtemp(prefix="nhans_chip_cards_")
    try:
        corpus = write_corpus(tmp, np.random.default_rng(9))
        cfg, seed, ref, _, _ = dp_reference(corpus)
        spec = dict(cfg=cfg, seed=seed, device=None, batch_utts=DP_UTTS,
                    steps=STEPS_DP, model_axis=False, cli=None,
                    out=f"{tmp}/p15f")
        res, wall = run_phase15_ranks(spec, "nccl")
        check_data_parallel(res, "[15f nccl]", ref, dp_golden(), smi[0])
        say(f"  the two ranks' processes took {wall:.1f} s")
        check_mesh_auto(served, count)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(smi[0])
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main_cards() if sys.argv[1:] == ["--cards"] else main())
