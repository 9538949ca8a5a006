#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nhans_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It
builds the CUDA kernels from csrc/, holds the spectrogram kernel against
its plain PyTorch version at the serving and training shapes and times it
by device time; holds the main tower's epilogue kernel
(csrc/tower_epilogue.cu) against its plain version bit for bit at every
block's serving shape, the fused tower against the modules on the shipped
weights, and times the epilogue against its plain version and the
modules (phase 4b); holds the main tower's convolution kernel
(csrc/tower_conv.cu) within the float32 bound of the float64 convolution
at its 16 shapes and times it against cuDNN, and the training step's 24
convolutions of both towers in three directions (forward and stride-1
input gradient through csrc/tower_conv.cu, weight and bias gradients
through csrc/conv_wgrad.cu) against float64 and cuDNN, timed beside it
(phase 4c); then drives the port's two main paths at full width:

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
  Adam (2 launches a step of the optimizer kernel, csrc/optimizer_update.cu,
  which is held bit for bit to its plain version at the separator's 393
  tensors and timed against it; in float32 54 launches a step of the
  convolution kernel and 32 of the weight-gradient kernel, and 32 forward
  and 32 backward calls of the epilogue kernels, csrc/train_epilogue.cu,
  which are held to their plain version at the step's 24 output shapes,
  bit for bit from run to run, and timed against it and the modules; none
  in bfloat16), a float32 forward and backward of the separator through
  the training convolutions and epilogues against the modules'
  gradients, leaf by leaf,
  with and without --remat (whose step must equal the plain one)
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
  NCCL and the denoiser command line with --mesh auto;
* model preparation and the checkpoint tools (phase 16): the shipped
  weights written as TF bundles, converted by ``nhans_tpu_torch.cli.
  load_denoiser``/``load_separator`` (every tensor exact) and served from
  the converted directory against phase 7's output; the serving command
  lines without a checkpoint against the JAX package's PRNGKey(0) output
  (tests/data/torch_golden_random_init.npz) and ``cli.evaluate`` without
  one; ``tools/ckpt_average`` and ``tools/ckpt_npz`` on phase 9's step
  directories and the averaged directory served; ``tools/validate_demo``
  on a synthetic DEMO_N-HANS tree against the plain spectrogram; and
  ``tools/train_supervisor`` in two chunks against phase 9's run;
* the installed package (phase 18): ``pip install --no-deps
  --no-build-isolation --target T`` of a copy of the sources, then
  ``T/bin/nhans_torch_denoiser`` with a temporary HOME and working
  directory and jax and nhans_tpu blocked, serving phase 7's input with
  the shipped weights (within 1e-6 of phase 7) through a kernel that nvcc
  built from T's sources under HOME/.cache/nhans_tpu_torch; the installed
  ``dsp.spectrogram`` on the card against its plain version; and the
  installed ``python -m nhans_tpu_torch.data.loader``;
* the JAX package's Orbax checkpoints (phase 19): the committed narrow
  fixtures (tests/data/orbax) read by the port's own OCDBT/zarr reader,
  served from the variables directory against its ``.npz`` twin, and the
  next step after ``cli.train --restore_path <Adam run root>`` against the
  JAX package's next step, with the time of each read;
* the port's own Orbax checkpoints at full width (phase 20):
  ``cli.train --alg adam --lr_schedule cosine`` saving an Orbax step (its
  write time, bytes and first read, every array read back bit for bit),
  a fresh trainer auto-resuming it against the uninterrupted run's next
  step, and the serving command line on the step directory against the
  same weights from a ``.npz``.

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
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, redirect_stderr, redirect_stdout

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

# phase 16: served waveforms of the TF-converted weights against the same
# weights from the .npz (phase 7): the same values through the same code
CONVERTED_ATOL = 1e-6

# phase 18: the installed copy serving phase 7's input against phase 7's
# output (the same code and weights on the same card); the phase of
# dsp.spectrogram against the plain version in float64, as
# |exp(i dphi) - 1| at bins with |X| >= PHASE_FLOOR x max|X| (at the atan2
# cut raw angles differ by 2 pi, and near |X| = 0 the angle is noise)
INSTALLED_ATOL = 1e-6
PHASE_ATOL = 1e-4
PHASE_FLOOR = 1e-3
# the lines of python -m nhans_tpu_torch.data.loader (and of the JAX one)
LOADER_LINE = re.compile(r"^\[(\d+)\] +\d+\.\d\d ms +\d+\.\d MB "
                         r"\( *\d+\.\d MB/s\)  queue=\d+$")

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


@contextmanager
def kernel_shapes(stft_cuda):
    """Record the input shape of every spectrogram kernel call.  The
    wrapper counts its launches on the module's ``log_spectrogram_kernel``
    (the recorder here), whose count goes back to the wrapper after."""
    kernel, shapes = stft_cuda.log_spectrogram_kernel, []

    def recorded(x, with_reim=False):
        shapes.append((tuple(x.shape), with_reim))
        return kernel(x, with_reim)

    recorded.launches = kernel.launches
    stft_cuda.log_spectrogram_kernel = recorded
    try:
        yield shapes
    finally:
        stft_cuda.log_spectrogram_kernel = kernel
        kernel.launches = recorded.launches


def in_process(argv_main, argv):
    """(stdout, stderr) of a command line's ``main`` run in this process,
    so that its kernel launches are counted here."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        argv_main(argv)
    return out.getvalue(), err.getvalue()


def served_wavs(run_dir, task, checkpoint, stft_cuda, wavs):
    """``cli.<task>`` run in this process on ``wavs`` (in, pos, neg int16
    arrays; pos None for none) with ``checkpoint`` ("" for none): (its
    output wavs by tag, stdout, stderr, kernel launches, kernel input
    shapes)."""
    import torch
    from scipy.io import wavfile

    from nhans_tpu_torch.cli._app import run

    os.makedirs(run_dir)
    paths = {}
    for name, x in zip(("in", "pos", "neg"), wavs):
        paths[name] = os.path.join(run_dir, f"{name}.wav") if x is not None \
            else ""
        if x is not None:
            wavfile.write(paths[name], SR, x)
    out_wav = os.path.join(run_dir, "out.wav")
    argv = ["--input", paths["in"], "--pos", paths["pos"], "--neg",
            paths["neg"], "--output", out_wav]
    if checkpoint:
        argv = ["--checkpoint", checkpoint, *argv]
    torch.cuda.synchronize()
    stft_cuda.log_spectrogram_kernel.launches = 0
    with kernel_shapes(stft_cuda) as shapes:
        stdout, stderr = in_process(lambda a: run(task, a), argv)
    torch.cuda.synchronize()
    launches = stft_cuda.log_spectrogram_kernel.launches
    tags = ("", "_mixed_processed", "_removed") + (
        ("_compensated",) if task == "denoiser" else ())
    got = {}
    for tag in tags:
        rate, x = wavfile.read(os.path.join(run_dir, f"out{tag}.wav"))
        check(rate == SR and x.dtype == np.float32 and np.isfinite(x).all(),
              f"{task} out{tag}.wav format / finite")
        got[tag] = x
    return got, stdout, stderr, launches, shapes


def phase16(tmp, corpus, smi, banked_losses, p7, phase5):
    """Phase 16: model preparation and the checkpoint tools, on the card.

    (a) The shipped weights as TF bundles through ``cli.load_denoiser`` and
        ``cli.load_separator`` (two processes at once): every tensor of the
        variables directories equals the ``.npz``'s; ``cli.denoiser
        --checkpoint <dir>`` on phase 7's input within 1e-6 of phase 7's
        output from the ``.npz``, 2 kernel launches.
    (b) ``cli.denoiser`` and ``cli.separator`` with no checkpoint: the
        WARNING, and the waveforms within WAVE_ATOL of the JAX package's
        ``PRNGKey(0)`` output (tests/data/torch_golden_random_init.npz);
        ``cli.evaluate`` with no checkpoint on phase 10's corpus.
    (c) ``tools/ckpt_average`` of phase 9's steps 4 and 8 equals their
        float64 mean; ``tools/ckpt_npz`` pack and unpack of step 8 (the
        shipped file's keys and dtypes, params within float16 rounding,
        batch_stats exact); the averaged directory serves.
    (d) ``tools/validate_demo`` on a synthetic DEMO_N-HANS tree from phase
        5's seeded signals, with the shipped weights, against the same
        tool on the plain spectrogram.
    (e) ``tools/train_supervisor --target 4 --chunk 2`` on phase 9's
        corpus: two processes, step 4's loss against phase 9's
        uninterrupted run at RESUME_RTOL.
    Returns the launches and kernel input shapes of (a) and (d)."""
    import torch

    from nhans_tpu_torch.cli import evaluate as cli_evaluate
    from nhans_tpu_torch.ops import stft_cuda
    from nhans_tpu_torch.tools import ckpt_average, ckpt_npz, validate_demo
    from nhans_tpu_torch.train.checkpoint import load, load_variables
    from tests.make_torch_golden import (DENOISER_NPZ, GOLDEN_RANDOM_INIT,
                                         SEPARATOR_NPZ, input_digest,
                                         random_init_inputs, write_demo_tree,
                                         write_tf_bundle)

    t0 = time.perf_counter()
    parts = {}  # wall s of each part
    root = os.path.join(tmp, "p16")
    os.makedirs(root)

    # (a) TF conversion, both tasks at once
    procs, shipped = {}, {}
    for task, npz in (("denoiser", DENOISER_NPZ),
                      ("separator", SEPARATOR_NPZ)):
        prefix = os.path.join(root, f"tf_{task}", "model-1000000")
        os.makedirs(os.path.dirname(prefix))
        shipped[task] = write_tf_bundle(npz, task, prefix)
        procs[task] = subprocess.Popen(
            [sys.executable, "-m", f"nhans_tpu_torch.cli.load_{task}",
             "--tf_checkpoint", prefix, "--output",
             os.path.join(root, f"{task}_ckpt")], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for task, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"load_{task} failed:\n{err}")
        got, _ = load(os.path.join(root, f"{task}_ckpt"))
        check(sorted(got) == sorted(shipped[task]), f"load_{task}: keys")
        for key, value in shipped[task].items():
            check(got[key].dtype == np.float32
                  and np.array_equal(got[key], value),
                  f"load_{task}: {key} differs from the .npz")
    say(f"[16a convert] cli.load_denoiser / load_separator of the shipped "
        f"weights as TF bundles ({len(shipped['denoiser'])} tensors each): "
        "every tensor equal to the .npz's")
    wavs_p7 = (p7["in"], None, p7["neg"])
    conv, _, _, conv_launches, conv_shapes = served_wavs(
        os.path.join(root, "serve_tf"), "denoiser",
        os.path.join(root, "denoiser_ckpt"), stft_cuda, wavs_p7)
    check(conv_launches == 2, f"converted serving: {conv_launches} launches")
    errs = {}
    for tag, want in p7["out"].items():
        check(conv[tag].shape == want.shape, f"converted out{tag} shape")
        errs[tag] = float(np.abs(conv[tag] - want).max())
        check(errs[tag] <= CONVERTED_ATOL, f"converted serving out{tag}: "
              f"{errs[tag]:.3g} from phase 7's")
    say(f"  cli.denoiser --checkpoint <converted dir> on phase 7's input: "
        f"{conv_launches} kernel launches ({conv_shapes}), max |diff| from "
        "phase 7's .npz output " + ", ".join(
            f"out{k}.wav {v:.3g}" for k, v in errs.items()))

    parts["a"] = time.perf_counter() - t0

    # (b) random initialisation
    with np.load(GOLDEN_RANDOM_INIT) as z:
        rgold = {k: z[k] for k in z.files}
    ri = random_init_inputs()
    check(str(rgold["input_sha256"]) == input_digest(
        *(x.astype(np.float64) for x in ri)), "random-init golden inputs")
    for task in ("denoiser", "separator"):
        got, stdout, stderr, launches, _ = served_wavs(
            os.path.join(root, f"random_{task}"), task, "", stft_cuda, ri)
        check("WARNING: no --checkpoint given" in stderr,
              f"{task}: no WARNING on stderr")
        check(launches == 2, f"random-init {task}: {launches} launches")
        errs = {}
        for tag, key in (("", f"{task}/denoised"),
                         ("_mixed_processed", "mixed_processed"),
                         ("_removed", f"{task}/removed")):
            check(got[tag].shape == rgold[key].shape, f"{task} {key} shape")
            errs[key] = float(np.abs(got[tag] - rgold[key]).max())
            check(errs[key] <= WAVE_ATOL, f"random-init {task} {key}: "
                  f"{errs[key]:.3g}")
        msg = ""
        if task == "denoiser":
            snr = float(stdout.splitlines()[0])
            want = float(rgold["denoiser/snr_est"])
            rel = abs(snr - want) / abs(want)
            check(rel <= SNR_RTOL, f"random-init snr_est {snr} against {want}")
            msg = f"; snr_est rel diff {rel:.3g}"
        say(f"[16b random init] cli.{task} without --checkpoint: WARNING on "
            "stderr; against the JAX PRNGKey(0) golden, max |diff| "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + msg)
    stdout, stderr = in_process(cli_evaluate.main, [
        "--speech_wav_dir", corpus[0], "--noise_wav_dir", corpus[1],
        "--eval_utts", "4", "--wav_dump_folder", "", "--dump_results", ""])
    check("WARNING: no --checkpoint given" in stderr, "cli.evaluate WARNING")
    printed = dict(line.split(": ", 1) for line in stdout.splitlines()
                   if ": " in line)
    check({"eval_loss", "si_sdr", "stoi"} <= set(printed)
          and all(np.isfinite(float(printed[k])) for k in printed),
          f"cli.evaluate random init: {printed}")
    say("  cli.evaluate without --checkpoint, 4 valid utterances: "
        + ", ".join(f"{k} {float(v):.4f}" for k, v in printed.items()))

    parts["b"] = time.perf_counter() - t0 - sum(parts.values())

    # (c) checkpoint tools on phase 9's step directories
    run_root = os.path.join(tmp, "ck_banked", "nhans")
    steps = [load_variables(os.path.join(run_root, str(s))) for s in (4, 8)]
    avg_dir = os.path.join(root, "avg")
    in_process(ckpt_average.main, ["--checkpoint_root", run_root, "--steps",
                                   "4,8", "--out", avg_dir])
    avg, _ = load(avg_dir)
    worst = 0.0
    for key, a in steps[0].items():
        want = (a.astype(np.float64) + steps[1][key]) / 2
        err = float(np.max(np.abs(avg[key] - want)
                           / np.maximum(np.abs(want), 1e-30)))
        check(avg[key].dtype == np.float32 and err <= 1e-7,
              f"ckpt_average {key}: rel {err:.3g}")
        worst = max(worst, err)
    packed_path = os.path.join(root, "step8.npz")
    packed = ckpt_npz.pack(os.path.join(run_root, "8"), packed_path)
    with np.load(DENOISER_NPZ) as z:
        want_dtypes = {k: z[k].dtype for k in z.files}
    check({k: v.dtype for k, v in packed.items()} == want_dtypes,
          "ckpt_npz pack: keys or dtypes differ from the shipped file's")
    back, _ = load(ckpt_npz.unpack(packed_path, os.path.join(root, "unp")))
    for key, value in steps[1].items():
        want = (value if key.startswith("batch_stats/")
                else value.astype(np.float16).astype(np.float32))
        check(np.array_equal(back[key], want), f"ckpt_npz round trip {key}")
    served, _, _, avg_launches, _ = served_wavs(
        os.path.join(root, "serve_avg"), "denoiser", avg_dir, stft_cuda,
        wavs_p7)
    check(avg_launches == 2, f"averaged serving: {avg_launches} launches")
    say(f"[16c tools] ckpt_average of phase 9's steps 4 and 8: max rel diff "
        f"{worst:.3g} from the float64 mean; ckpt_npz pack of step 8 "
        f"({os.path.getsize(packed_path) / 1e6:.1f} MB, the shipped keys "
        "and dtypes) and unpack: params at float16 rounding, batch_stats "
        "exact; cli.denoiser --checkpoint <averaged dir>: 4 finite wavs, "
        f"{avg_launches} kernel launches")

    parts["c"] = time.perf_counter() - t0 - sum(parts.values())

    # (d) validate_demo on a synthetic DEMO_N-HANS tree
    _, mixed5, _, neg5 = phase5
    n = 3 * SR
    demo = os.path.join(root, "DEMO_N-HANS")
    write_demo_tree(demo, mixed5[1][:n], neg5[:n], np.resize(mixed5[0], n))
    records, vd_launches, vd_shapes = {}, 0, []
    for task, npz in (("denoiser", DENOISER_NPZ),
                      ("separator", SEPARATOR_NPZ)):
        argv = ["--demo_root", demo, "--task", task, "--checkpoint", npz,
                "--ac"]
        torch.cuda.synchronize()
        stft_cuda.log_spectrogram_kernel.launches = 0
        with kernel_shapes(stft_cuda) as shapes:
            got = validate_demo.main(argv)
        torch.cuda.synchronize()
        vd_launches += stft_cuda.log_spectrogram_kernel.launches
        vd_shapes += shapes
        with plain_spectrogram(stft_cuda):
            want = validate_demo.main(argv)
        check(len(got) == len(want) == 1 and set(got[0]) == set(want[0]),
              f"validate_demo {task}: records")
        diffs = {}
        for key, value in want[0].items():
            if key == "example":
                continue
            bar = 1e-4 if key.startswith("stoi") else 1e-3
            diffs[key] = abs(got[0][key] - value)
            check(diffs[key] <= bar, f"validate_demo {task} {key}: "
                  f"{got[0][key]} against {value} on the plain spectrogram")
        records[task] = (got[0], diffs)
    check(vd_launches == 4, f"validate_demo: {vd_launches} launches")
    for task, (rec, diffs) in records.items():
        say(f"[16d validate_demo] {task}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec.items() if k != "example")
            + "; against the plain spectrogram, max |diff| "
            + f"{max(diffs.values()):.3g}")
    say(f"  {vd_launches} kernel launches ({vd_shapes})")

    parts["d"] = time.perf_counter() - t0 - sum(parts.values())

    # (e) the supervisor over cli.train on phase 9's corpus
    ck, summ = os.path.join(root, "ck_sup"), os.path.join(root, "sum_sup")
    t_sup = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "nhans_tpu_torch.tools.train_supervisor",
         "--target", "4", "--chunk", "2", "--", "--speech_wav_dir",
         corpus[0], "--noise_wav_dir", corpus[1], "--checkpoint_dir", ck,
         "--summaries_dir", summ, "--eval_utts", "0",
         "--train_monitor_every", "1", "--eval_every", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    w_sup = time.perf_counter() - t_sup
    check(r.returncode == 0, f"train_supervisor failed:\n{r.stderr[-3000:]}")
    chunks = [line for line in r.stdout.splitlines()
              if line.startswith("supervisor: [")]
    check(len(chunks) == 2 and "target 4 reached" in r.stdout,
          f"train_supervisor: {chunks}")
    with open(os.path.join(summ, "nhans.jsonl")) as f:
        losses = {rec["step"]: rec["loss"] for rec in map(json.loads, f)
                  if "loss" in rec}
    check(sorted(losses) == [1, 2, 3, 4], f"supervised steps {sorted(losses)}")
    rel = abs(losses[4] - banked_losses[4]) / abs(banked_losses[4])
    check(rel <= RESUME_RTOL, f"supervised step 4: loss {losses[4]} against "
          f"{banked_losses[4]}")
    say(f"[16e supervisor] --target 4 --chunk 2: 2 processes ("
        + "; ".join(c.split("] ")[0] + "]" for c in chunks)
        + f") in {w_sup:.1f} s; step 4 loss {losses[4]:.7f} against "
        f"{banked_losses[4]:.7f} uninterrupted (rel {rel:.2g})")
    wall = time.perf_counter() - t0
    parts["e"] = wall - sum(parts.values())
    say(f"[16] phase 16 wall time {wall:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
        + f") on {smi}")
    return dict(conv_launches=conv_launches, conv_shapes=conv_shapes,
                vd_launches=vd_launches, vd_shapes=vd_shapes, wall=wall)


# Phase 18's process in the installed copy, with jax and nhans_tpu
# blocked: the installed nhans_torch_denoiser script run as its file with
# the kernel's calls recorded, then dsp.spectrogram on the card against its
# plain version; one "P18 {json}" line on stdout.
_P18_PROC = r"""
import json, runpy, sys
for name in ("jax", "jaxlib", "flax", "nhans_tpu"):
    sys.modules[name] = None
script, argv = sys.argv[1], sys.argv[2:]
import numpy as np
import torch
from nhans_tpu_torch.dsp import (istft_from_logmag, spectrogram,
                                 stft_magphase, strided_windows)
from nhans_tpu_torch.ops import _build, stft_cuda

kernel, shapes = stft_cuda.log_spectrogram_kernel, []


def recorded(x, with_reim=False):
    shapes.append([list(x.shape), with_reim])
    return kernel(x, with_reim)


recorded.launches = 0  # the wrapper counts on the module's name
stft_cuda.log_spectrogram_kernel = recorded
sys.argv = [script, *argv]
try:
    runpy.run_path(script, run_name="__main__")
    code = 0
except SystemExit as e:
    code = e.code or 0
torch.cuda.synchronize()
stft_cuda.log_spectrogram_kernel = kernel
record = _build._LOADED["log_spectrogram"][1]
res = {"code": code, "launches": recorded.launches, "shapes": shapes,
       "lib": record["path"], "build_s": record["seconds"],
       "module": stft_cuda.__file__}

rng = np.random.default_rng(18)
x = torch.from_numpy((rng.standard_normal((4, 160000)) * 0.3)
                     .astype(np.float32)).cuda()
lm, ph = spectrogram(x)
lm32, re32, im32 = stft_cuda.log_spectrogram_plain(x, True)
lm64, re64, im64 = stft_cuda.log_spectrogram_plain(x.double(), True)
torch.cuda.synchronize()
mag64 = torch.sqrt(re64 * re64 + im64 * im64)
keep = mag64 >= PHASE_FLOOR * mag64.max()


def phase_err(ref):
    d = (ph.double() - ref)[keep]
    return float(torch.sqrt((torch.cos(d) - 1) ** 2
                            + torch.sin(d) ** 2).max())


wave = istft_from_logmag(lm64[0], torch.atan2(im64[0], re64[0]))
inner = slice(400, wave.shape[-1] - 400)
mag, _ = stft_magphase(x[:1])
windows = strided_windows(lm[0], 35)
res.update(
    lm_err64=float((lm.double() - lm64).abs().max()),
    lm_err32=float((lm - lm32).abs().max()),
    phase_err64=phase_err(torch.atan2(im64, re64)),
    phase_err32=phase_err(torch.atan2(im32, re32).double()),
    kept=int(keep.sum()), bins=int(keep.numel()),
    roundtrip_err=float((wave[inner] - x[0].double()[inner]).abs().max()
                        / x[0].abs().max()),
    mag_err=float((mag.double() - mag64[:1]).abs().max() / mag64.max()),
    windows_ok=bool(tuple(windows.shape) == (lm.shape[1], 35, 201)
                    and torch.equal(windows[:, 17], lm[0])))
print("P18 " + json.dumps(res), flush=True)
""".replace("PHASE_FLOOR", repr(PHASE_FLOOR))


def phase18(tmp, corpus, smi, p7):
    """Phase 18: the installed package, on the card.

    ``setup.py``, ``nhans_tpu/`` and ``nhans_tpu_torch/`` copied to a
    temporary directory (setuptools writes ``build/`` and ``*.egg-info``
    beside ``setup.py``) and installed with ``pip install --no-deps
    --no-build-isolation --target T``.  In T, with ``PYTHONPATH=T``, a
    temporary working directory and ``HOME``, and jax and nhans_tpu
    blocked: ``T/bin/nhans_torch_denoiser --checkpoint
    docs/quality/denoiser_q5_swa.npz`` on phase 7's input exits 0 within
    INSTALLED_ATOL of phase 7's four wavs, through a kernel that nvcc built
    from T's sources into ``HOME/.cache/nhans_tpu_torch/build`` (not under
    T, not under the repository), 2 launches; ``dsp.spectrogram`` on the
    card at [4, 160000] against the plain version at phase 3's log-magnitude
    bar and PHASE_ATOL; and, at the same time, ``python -m
    nhans_tpu_torch.data.loader --iters 3`` on phase 9's corpus.  Returns
    the launches, the kernel's input shapes and the wall time."""
    from scipy.io import wavfile

    t0 = time.perf_counter()
    root = os.path.join(tmp, "p18")
    src, target = os.path.join(root, "src"), os.path.join(root, "target")
    home, work = os.path.join(root, "home"), os.path.join(root, "work")
    for d in (src, home, work):
        os.makedirs(d)
    shutil.copy(os.path.join(REPO, "setup.py"), src)
    for pkg in ("nhans_tpu", "nhans_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), os.path.join(src, pkg),
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc",
                                                      "*.so"))
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps",
         "--no-build-isolation", "--no-cache-dir", "--target", target, src],
        cwd=root, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"pip install failed:\n{r.stdout}{r.stderr}")
    pip_s = time.perf_counter() - t0
    script = os.path.join(target, "bin", "nhans_torch_denoiser")
    check(os.path.isfile(script), "pip installed no nhans_torch_denoiser")

    env = dict(os.environ, PYTHONPATH=target, HOME=home)
    loader = subprocess.Popen(
        [sys.executable, "-m", "nhans_tpu_torch.data.loader", "--iters", "3",
         "--speech_wav_dir", corpus[0], "--noise_wav_dir", corpus[1]],
        cwd=home, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        for name in ("in", "neg"):
            wavfile.write(os.path.join(work, f"{name}.wav"), SR, p7[name])
        out_wav = os.path.join(work, "out.wav")
        t_serve = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c", _P18_PROC, script, "--checkpoint",
             os.path.join(REPO, "docs", "quality", "denoiser_q5_swa.npz"),
             "--input", os.path.join(work, "in.wav"), "--neg",
             os.path.join(work, "neg.wav"), "--pos", "", "--output",
             out_wav], cwd=work, env=env, capture_output=True, text=True,
            timeout=600)
        serve_s = time.perf_counter() - t_serve
        check(r.returncode == 0, f"installed denoiser failed:\n{r.stderr}")
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("P18 ")]
        check(len(lines) == 1, f"no P18 line:\n{r.stdout}")
        res = json.loads(lines[0][4:])
        l_out, l_err = loader.communicate(timeout=300)
    finally:
        if loader.poll() is None:
            loader.kill()
            loader.wait()
    check(res["code"] == 0, f"nhans_torch_denoiser exited {res['code']}")
    shapes = [(tuple(sh), reim) for sh, reim in res["shapes"]]
    check(res["launches"] == len(shapes) == 2 and sorted(shapes) == [
        ((1, 52000), True), ((2, 32240), False)],
        f"installed denoiser: {res['launches']} launches, shapes {shapes}")
    cache = os.path.realpath(os.path.join(home, ".cache", "nhans_tpu_torch",
                                          "build"))
    lib = os.path.realpath(res["lib"])
    check(lib.startswith(cache + os.sep) and os.path.isfile(lib),
          f"the kernel library {lib} is not under {cache}")
    for tree in (target, REPO):
        check(not lib.startswith(os.path.realpath(tree) + os.sep),
              f"the kernel library {lib} lies under {tree}")
    check(res["build_s"] > 0, "the installed copy did not build its kernel")
    check(os.path.realpath(res["module"]).startswith(
        os.path.realpath(target) + os.sep),
        f"stft_cuda came from {res['module']}, not the installed copy")
    errs = {}
    for tag, want in p7["out"].items():
        rate, x = wavfile.read(os.path.join(work, f"out{tag}.wav"))
        check(rate == SR and x.dtype == np.float32 and len(x) == len(want),
              f"installed out{tag}.wav format / length")
        errs[tag] = float(np.abs(x - want).max())
        check(errs[tag] <= INSTALLED_ATOL, f"installed out{tag}.wav: max "
              f"|diff| {errs[tag]:.3g} > {INSTALLED_ATOL} from phase 7")
    check(res["lm_err64"] <= LM_ATOL, f"installed spectrogram: log-magnitude "
          f"err {res['lm_err64']} against float64")
    check(res["phase_err64"] <= PHASE_ATOL, f"installed spectrogram: phase "
          f"err {res['phase_err64']} against float64")
    check(res["roundtrip_err"] <= 1e-4 and res["mag_err"] <= REIM_EXACT_RTOL
          and res["windows_ok"], f"installed dsp functions: {res}")
    check(loader.returncode == 0, f"installed loader failed:\n{l_err}")
    l_lines = [ln for ln in l_out.splitlines() if ln.startswith("[")]
    check(len(l_lines) == 3 and all(LOADER_LINE.match(ln) for ln in l_lines),
          f"installed loader printed:\n{l_out}")
    wall = time.perf_counter() - t0
    say(f"[18 installed] pip install --target in {pip_s:.1f} s; "
        f"T/bin/nhans_torch_denoiser (PYTHONPATH=T, HOME and cwd temporary, "
        f"jax and nhans_tpu blocked) served phase 7's input in {serve_s:.1f} "
        f"s with start-up: exit 0, {res['launches']} kernel launches "
        f"{shapes}, the kernel built by nvcc from T's csrc/ in "
        f"{res['build_s']:.2f} s into HOME/.cache/nhans_tpu_torch/build/"
        f"{os.path.basename(lib)}; max |diff| from phase 7 "
        + ", ".join(f"out{k}.wav {v:.3g}" for k, v in errs.items()))
    say(f"  dsp.spectrogram [4, 160000] on the card: log-magnitude against "
        f"float64 {res['lm_err64']:.3g} (float32 plain {res['lm_err32']:.3g}),"
        f" phase |exp(i dphi) - 1| against float64 {res['phase_err64']:.3g} "
        f"(float32 plain {res['phase_err32']:.3g}) on {res['kept']} of "
        f"{res['bins']} bins with |X| >= {PHASE_FLOOR} max|X|; "
        f"istft_from_logmag round trip {res['roundtrip_err']:.3g} of the "
        f"peak, stft_magphase {res['mag_err']:.3g} of max|X|")
    for ln in l_lines:
        say(f"  python -m nhans_tpu_torch.data.loader (installed): {ln}")
    say(f"[18] phase 18 wall time {wall:.1f} s, {res['launches']} kernel "
        f"launches, on {smi}")
    return {"launches": res["launches"], "shapes": shapes, "wall": wall}


def phase19(tmp, smi, p7):
    """Phase 19: the JAX package's Orbax checkpoints, read by the port's
    own reader (tests/data/orbax: written by the JAX package's
    save_variables and Checkpointer at the narrow widths of
    tests/make_torch_golden.py's ORBAX_MODEL, the full-width model's
    names; no JAX here).

    (a) The serving command line in this process, its model narrowed to
        the fixture's widths (it has no width flags), with ``--checkpoint
        <the variables directory>`` on phase 7's input: the same wavs as
        with the directory's ``.npz`` twin (0 max |diff|), 2 kernel
        launches.
    (b) ``cli.train``'s Trainer with ``--restore_path <the Adam run root>
        --alg adam`` (the model narrowed): it continues at step 1 with
        update count 1, and its next step on the golden's inputs and
        draws lies within phase 8's bars of the JAX package's next step
        (tests/data/orbax/next_step.npz); 4 kernel launches.
    The wall time of each fixture's first read in this process is
    recorded.  Returns the launches and kernel input shapes of (a) and
    (b)."""
    import torch

    from nhans_tpu_torch.cli import _app
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.ops import stft_cuda
    from nhans_tpu_torch.train import checkpoint as ckpt
    from tests.make_torch_golden import (golden_train_inputs, input_digest,
                                         narrow, orbax_paths, port_orbax_step,
                                         port_orbax_trainer)

    t_phase = time.perf_counter()
    paths = orbax_paths()
    root = os.path.join(tmp, "p19")
    os.makedirs(root)
    reads = {}
    for name in ("variables", "run"):
        t0 = time.perf_counter()
        variables, state = ckpt.load(paths[name], alg="adam")
        reads[name] = time.perf_counter() - t0
        n = len(variables) + len(state or {})
        say(f"[19 read] {name} fixture: {n} arrays in {reads[name]:.3f} s "
            "(first read in this process)")

    # (a) serving from the variables directory and from its twin
    class NarrowConfig:
        """Config, its serving models at the fixture's widths."""
        denoiser = staticmethod(lambda: narrow(Config.denoiser()))
        separator = staticmethod(lambda: narrow(Config.separator()))

    wavs = (p7["in"], None, p7["neg"])
    wide, _app.Config = _app.Config, NarrowConfig
    try:
        got, _, _, serve_launches, serve_shapes = served_wavs(
            os.path.join(root, "orbax"), "denoiser", paths["variables"],
            stft_cuda, wavs)
        twin, _, _, _, _ = served_wavs(os.path.join(root, "npz"), "denoiser",
                                       paths["npz"], stft_cuda, wavs)
    finally:
        _app.Config = wide
    check(serve_launches == 2, f"Orbax serving: {serve_launches} launches")
    check(sorted(got) == sorted(twin), "Orbax serving: output files")
    errs = {tag: float(np.abs(got[tag] - twin[tag]).max()) for tag in twin}
    check(max(errs.values()) == 0.0, f"Orbax serving against the .npz twin: "
          f"{errs}")
    say(f"[19a serve] cli.denoiser --checkpoint tests/data/orbax/variables "
        f"(narrowed) on phase 7's input: {serve_launches} kernel launches "
        f"({serve_shapes}); max |diff| from the .npz twin " + ", ".join(
            f"out{tag} {v:.3g}" for tag, v in errs.items()))

    # (b) the next step after --restore_path
    with np.load(paths["golden"]) as z:
        golden = {k: z[k] for k in z.files}
    check(str(golden["input_sha256"]) == input_digest(
        *golden_train_inputs(int(golden["seed"])).values()),
        "Orbax golden inputs do not regenerate")
    t0 = time.perf_counter()
    trainer = port_orbax_trainer(paths["run"], "adam", "cuda", root)
    restore_s = time.perf_counter() - t0
    check(trainer.tstep == int(golden["step"]) == 1
          and int(trainer.state.opt_state["count"]) == 1,
          f"resumed at step {trainer.tstep}, count "
          f"{trainer.state.opt_state['count']}")
    torch.cuda.synchronize()
    stft_cuda.log_spectrogram_kernel.launches = 0
    with kernel_shapes(stft_cuda) as step_shapes:
        step = port_orbax_step(trainer, golden)
    torch.cuda.synchronize()
    step_launches = stft_cuda.log_spectrogram_kernel.launches
    check(step_launches == 4, f"resumed step: {step_launches} launches")
    say(f"[19b resume] Trainer built in {restore_s:.2f} s, at step "
        f"{trainer.tstep}; " + step_errors(
            step, golden, "cli.train --restore_path <Orbax run> --alg adam, "
            "next step against the JAX package's")
        + f"; {step_launches} kernel launches ({step_shapes})")
    del trainer
    wall = time.perf_counter() - t_phase
    say(f"[19] phase 19 wall time {wall:.1f} s on {smi}")
    return {"serve_launches": serve_launches, "serve_shapes": serve_shapes,
            "step_launches": step_launches, "step_shapes": step_shapes,
            "reads": reads}


def phase20(tmp, corpus, smi, p7):
    """Phase 20: the port writes the JAX package's Orbax checkpoints at
    full width (compat/orbax.py; the JAX package reads them in the CPU
    tests, tests/test_torch_orbax_write.py).

    (a) ``cli.train``'s Trainer at full width on phase 9's corpus with
        ``--alg adam --lr_schedule cosine --lr_decay_steps 100 --batches
        3 --eval_every 2``: it takes 2 steps and saves step 2 through
        ``save_and_eval`` (the write's wall time and the directory's
        bytes), then takes its third step, the uninterrupted run's, and
        saves it.  Every array read back from step 2 equals the state in
        memory at the save bit for bit, dtypes too (int32 step and
        counts, float32 arrays); 4 kernel launches a step at [16, 163600].
    (b) The first full-width read of step 2 in this process: its
        variables (``load_variables``), its train state (``load``) and
        its raw tree (``compat/orbax.read``), by wall time, the page
        cache warm from the write.
    (c) A fresh Trainer on that run root (step 3 taken out) auto-resumes
        at step 2 with update count 2, its state the saved one exactly,
        and its step 3 lies within phase 8's resume bars of the
        uninterrupted run's: loss 1e-4 relative, each update within 1e-4
        of its largest |delta| (the noise biases aside, as in phase 12).
        Both runs use cuDNN's deterministic algorithms, so the bars
        measure the checkpoint and not cuDNN's order of summation.
    (d) The serving command line in this process with ``--checkpoint <step
        2's directory>`` on phase 7's input: the same wavs as the same
        weights from a flat ``.npz`` (0 max |diff|), 2 kernel launches.
    Returns the launches and kernel input shapes of (a) + (c) and (d)."""
    import torch

    from nhans_tpu_torch.cli import train as cli_train
    from nhans_tpu_torch.compat import orbax
    from nhans_tpu_torch.ops import stft_cuda
    from nhans_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "p20")
    flags = ["--speech_wav_dir", corpus[0], "--noise_wav_dir", corpus[1],
             "--checkpoint_dir", os.path.join(root, "ck"), "--eval_utts",
             "0", "--train_monitor_every", "1", "--alg", "adam",
             "--lr_schedule", "cosine", "--lr_decay_steps", "100",
             "--batches", "3", "--eval_every", "2"]

    def trained(name, trainer):
        """Train ``trainer`` with the counts at 0: (its launches, kernel
        input shapes, losses by step, its state after as flat arrays)."""
        torch.cuda.synchronize()
        stft_cuda.log_spectrogram_kernel.launches = 0
        first = trainer.tstep
        with kernel_shapes(stft_cuda) as shapes:
            trainer.train()
        torch.cuda.synchronize()
        launches = stft_cuda.log_spectrogram_kernel.launches
        check(launches == 4 * (trainer.tstep - first),
              f"{name}: {launches} launches in {trainer.tstep - first} steps")
        check(sorted(set(shapes)) == [((16, 163600), False)],
              f"{name}: kernel shapes {sorted(set(shapes))}")
        with open(os.path.join(root, f"sum_{name}", "nhans.jsonl")) as f:
            losses = {r["step"]: r["loss"] for r in map(json.loads, f)
                      if "loss" in r}
        return launches, shapes, losses, ckpt.orbax_train_state(
            trainer._full_state(), trainer.ckpt.chain)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # (a) the uninterrupted run, its save at step 2 timed
        run = cli_train.build_trainer(
            [*flags, "--summaries_dir", os.path.join(root, "sum_run")])
        saves, save = {}, run.ckpt.save

        def timed_save(step, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(step, state)
            seconds = time.perf_counter() - t0
            saves[step] = (path, seconds,
                           ckpt.orbax_train_state(state, run.ckpt.chain))
            return path

        run.ckpt.save = timed_save
        launches_a, shapes_a, losses_a, after_a = trained("run", run)
        check(sorted(saves) == [2, 3], f"saves at steps {sorted(saves)}")
        step_dir, write_s, snap = saves[2]
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(step_dir) for f in fs)
        want = {k: v for k, v in snap.items() if v is not None}

        # (b) the first reads, and the arrays against the state saved
        t0 = time.perf_counter()
        variables = ckpt.load_variables(step_dir)
        read_vars = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, extra = ckpt.load(step_dir, alg="adam")
        read_state = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = orbax.read(os.path.join(step_dir, "default"))
        read_raw = time.perf_counter() - t0
        check(sorted(raw) == sorted(want), "Orbax step 2: its arrays")
        bad = [k for k, v in want.items() if raw[k].dtype != v.dtype
               or not np.array_equal(raw[k], v)]
        check(not bad, f"Orbax step 2 differs from the saved state: "
              f"{bad[:8]}")
        check(all(np.array_equal(variables[k], want[k]) for k in variables)
              and sorted(variables) == sorted(
                  k for k in want if k.split("/")[0] in ("params",
                                                         "batch_stats")),
              "Orbax step 2: load_variables")
        check(int(extra["step"]) == int(extra["opt/count"]) == 2,
              "Orbax step 2: load's step and count")
        say(f"[20a write] cli.train --alg adam --lr_schedule cosine, full "
            f"width: losses " + ", ".join(f"{losses_a[k]:.6f}"
                                          for k in sorted(losses_a))
            + f"; step 2 written in {write_s:.3f} s ({nbytes} bytes, "
            f"{len(want)} arrays, {len(snap) - len(want)} empty nodes); "
            f"every array read back bit for bit; {launches_a} kernel "
            f"launches in 3 steps on {smi}")
        say(f"[20b read] first full-width read of step 2: variables "
            f"{read_vars:.3f} s ({len(variables)} arrays), train state "
            f"{read_state:.3f} s, raw tree {read_raw:.3f} s ({len(raw)} "
            f"arrays; page cache warm from the write) on {smi}")

        # (c) a fresh trainer on that run root, step 3 taken out
        shutil.rmtree(os.path.join(run.ckpt.path, "3"))
        del run
        resumed = cli_train.build_trainer(
            [*flags, "--summaries_dir", os.path.join(root, "sum_resumed")])
        check(resumed.tstep == 2
              and int(resumed.state.opt_state["count"]) == 2,
              f"auto-resumed at step {resumed.tstep}, count "
              f"{resumed.state.opt_state['count']}")
        state2 = ckpt.orbax_train_state(resumed._full_state(),
                                        resumed.ckpt.chain)
        check(all(np.array_equal(state2[k], v) for k, v in want.items()),
              "the resumed state is not the saved one")
        launches_c, shapes_c, losses_c, after_c = trained("resumed",
                                                          resumed)
        del resumed
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = abs(losses_c[3] - losses_a[3]) / abs(losses_a[3])
    check(sorted(losses_c) == [3] and rel <= RESUME_RTOL,
          f"resumed step 3: loss {losses_c} against {losses_a[3]}")
    noise = tuple(n.replace(".", "/") for n in NOISE_BIASES)
    upd = {}
    for k, v in after_a.items():
        if not k.startswith("params/"):
            continue
        delta = np.abs(v - snap[k]).max()
        upd[k] = float(np.abs(after_c[k] - v).max() / max(delta, 1e-30))
    worst = max((k for k in upd if not k.endswith(noise)), key=upd.get)
    check(upd[worst] <= RESUME_RTOL, f"resumed step 3: update {worst} "
          f"{upd[worst]}")
    stats = max(float(np.abs(after_c[k] - v).max())
                for k, v in after_a.items() if k.startswith("batch_stats/"))
    say(f"[20c resume] auto-resumed at step 2 (count 2, state exact); step 3 "
        f"loss {losses_c[3]:.7f} against {losses_a[3]:.7f} uninterrupted "
        f"(rel {rel:.2g}); worst update max |diff| / max |delta| "
        f"{upd[worst]:.2g} ({worst}), noise biases "
        f"{max(v for k, v in upd.items() if k.endswith(noise)):.2g}; "
        f"statistics max |diff| {stats:.2g}; {launches_c} kernel launches")

    # (d) serving step 2's directory and the same weights from a .npz
    npz = os.path.join(root, "step2.npz")
    np.savez(npz, **variables)
    wavs = (p7["in"], None, p7["neg"])
    got, _, _, serve_launches, serve_shapes = served_wavs(
        os.path.join(root, "orbax"), "denoiser", step_dir, stft_cuda, wavs)
    twin, _, _, _, _ = served_wavs(os.path.join(root, "npz"), "denoiser",
                                   npz, stft_cuda, wavs)
    check(serve_launches == 2, f"Orbax step serving: {serve_launches} "
          "launches")
    check(sorted(got) == sorted(twin), "Orbax step serving: output files")
    errs = {tag: float(np.abs(got[tag] - twin[tag]).max()) for tag in twin}
    check(max(errs.values()) == 0.0, f"Orbax step serving against the .npz: "
          f"{errs}")
    say(f"[20d serve] cli.denoiser --checkpoint <step 2> on phase 7's input: "
        f"{serve_launches} kernel launches ({serve_shapes}); max |diff| from "
        "the same weights as .npz " + ", ".join(
            f"out{tag} {v:.3g}" for tag, v in errs.items()))
    wall = time.perf_counter() - t_phase
    say(f"[20] phase 20 wall time {wall:.1f} s on {smi}")
    return {"train_launches": launches_a + launches_c,
            "train_shapes": shapes_a + shapes_c,
            "serve_launches": serve_launches, "serve_shapes": serve_shapes,
            "write_s": write_s, "bytes": nbytes, "read_vars_s": read_vars,
            "read_state_s": read_state}


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


# phase 4b: the main tower's blocks at full width, (C, H, W) of each
# stage's activation, native geometry, and the windows of a serving call:
# a chunk of the folder (window_chunk), a ragged tail and one window
TOWER_STAGES = ((64, 35, 201), (128, 18, 101), (256, 9, 51), (512, 5, 26))
EPILOGUE_WINDOWS = (2048, 795, 1)
# the fused tower (the convolution kernel's sums in their own order)
# against the modules (cuDNN, TF32 off): max |diff| over the modules'
# largest residual.  Each convolution's output moves by a few float32
# roundings (rms 2e-7 to 1e-6 of unit outputs, phase 4c); TF32 in the
# modules moves the residual by about 1e-3 of its largest.
TOWER_RTOL = 2e-5
# a full step's gradients through the training kernels against the
# modules' (cuDNN, TF32 off), by leaf over the larger of the leaf's norm and
# the median leaf's (the benchmark's grad_gap): both are float32 sums in
# other orders, which BatchNorm's backward amplifies in a few leaves
STEP_GRAD_GAP = 1e-2
# the training kernels' rms error against the float64 result, at most this
# many times cuDNN's float32 one (TF32 off) in the same direction: both are
# float32 sums of the same products in another order
TRAIN_CONV_RMS_X = 2.0


def epilogue_tables(N, C, H, W, dev, seed):
    """A random activation y, the epilogue's tables and a residual, in
    float32 on ``dev``, as tests/test_torch_epilogue.py makes them."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    tabs = [r(N, C), r(N, C), r(C, H), r(C, W), r(C, scale=0.5),
            torch.rsqrt(r(C).abs() + 0.5) * r(C), r(C, scale=0.5)]
    return r(N, C, H, W, scale=2.0), tabs, r(N, C, H, W)


def phase4b(dev, cycles_per_ms, smi):
    """The main tower's epilogue kernel on the card.

    (a) ``ops.tower_epilogue`` against ``tower_epilogue_plain`` at every
        stage's shape with 2048, 795 and 1 windows, without and with the
        residual: equal bit for bit.
    (b) the shipped denoiser's tower fused (inference mode: the epilogue
        and convolution kernels) against its modules (grad on, no
        parameter needing it; cuDNN, TF32 off) on 2048, 795 and 1 windows:
        max |diff| within TOWER_RTOL of the modules' largest residual, and
        16 launches of each kernel per forward.
    (c) device time of one block's two epilogues (conv1's, and conv2's
        with the residual) at a 2048-window chunk: the kernel, its plain
        version, and the modules' eager passes of the shipped block
        (Inject with its projections and position MLPs, [residual,]
        BatchNorm, ReLU); the bound is 5 transfers of the activation at
        the card's bandwidth.
    Returns (max |err| over (a), timings by stage)."""
    import torch

    from nhans_tpu_torch.compat.weights import load_npz
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.nn.model import NHANSNet
    from nhans_tpu_torch.ops import tower_epilogue as te
    from nhans_tpu_torch.ops.tower_conv import tower_conv
    from nhans_tpu_torch.tools.devtime import device_ms
    from nhans_tpu_torch.utils.device import full_float32
    from tests.make_torch_golden import DENOISER_NPZ

    def bits(x):
        return x.view(torch.int32)

    # (a)
    max_err = 0.0
    for C, H, W in TOWER_STAGES:
        for N in EPILOGUE_WINDOWS:
            y, tabs, res = epilogue_tables(N, C, H, W, dev, N + C)
            errs = []
            for r in (None, res):
                before = te.tower_epilogue.launches
                got = te.tower_epilogue(y, *tabs, residual=r)
                ref = te.tower_epilogue_plain(y, *tabs, r)
                check(te.tower_epilogue.launches == before + 1,
                      f"epilogue [{N}, {C}, {H}, {W}]: launches")
                check(torch.equal(bits(got), bits(ref)),
                      f"epilogue [{N}, {C}, {H}, {W}] residual "
                      f"{r is not None}: not bit for bit the plain version")
                errs.append((got - ref).abs().max().item())
                del got, ref
            max_err = max(max_err, *errs)
            say(f"[4b epilogue] [{N}, {C}, {H}, {W}]: kernel against plain, "
                f"bit for bit, max |diff| {errs[0]} without and {errs[1]} "
                "with the residual")
            del y, tabs, res
            torch.cuda.empty_cache()

    # (b)
    model = NHANSNet(Config.denoiser().model)
    model.load_state_dict(load_npz(DENOISER_NPZ), strict=True)
    model = model.to(dev).eval().requires_grad_(False)
    for N in EPILOGUE_WINDOWS:
        g = torch.Generator(device=dev).manual_seed(N)
        x = torch.randn(N, 35, 201, device=dev, generator=g) * 2 - 4
        ea = torch.randn(N, 512, device=dev, generator=g)
        eb = torch.randn(N, 512, device=dev, generator=g)
        before = (te.tower_epilogue.launches, tower_conv.launches)
        with torch.inference_mode(), full_float32():
            fused = model(x, emb_a=ea, emb_b=eb)
        launches = (te.tower_epilogue.launches - before[0],
                    tower_conv.launches - before[1])
        with torch.enable_grad(), full_float32():
            ref = model(x, emb_a=ea, emb_b=eb)
        diff = (fused - ref).abs().max().item()
        rel = diff / ref.abs().max().item()
        blocks = len(Config.denoiser().model.main_blocks)
        check(launches == (2 * blocks, 2 * blocks),
              f"fused tower, {N} windows: {launches} epilogue and "
              "convolution launches")
        check(rel <= TOWER_RTOL, f"fused tower, {N} windows: max |diff| "
              f"{diff} from the modules, {rel:.3g} of their largest")
        say(f"[4b epilogue] shipped denoiser, {N} windows: fused tower "
            f"against the modules max |diff| {diff:.4g}, {rel:.3g} of the "
            f"largest residual; {launches[0]} epilogue and {launches[1]} "
            "convolution launches")
        del x, ea, eb, fused, ref
    torch.cuda.empty_cache()

    # (c)
    timings = {}
    N = EPILOGUE_WINDOWS[0]
    blocks = [getattr(model, f"resblock{2 * i + 2}") for i in range(4)]
    for (C, H, W), block in zip(TOWER_STAGES, blocks):
        y, tabs, res = epilogue_tables(N, C, H, W, dev, C)
        g = torch.Generator(device=dev).manual_seed(C)
        ea = torch.randn(N, 512, device=dev, generator=g)
        eb = torch.randn(N, 512, device=dev, generator=g)

        def modules():
            v = block._mask(torch.relu(block.bn1(block.inject1(y, ea, eb))))
            del v
            v = block.inject2(y, ea, eb) + res
            return block._mask(torch.relu(block.bn_out(v)))

        fns = {"ms": lambda: (te.tower_epilogue(y, *tabs),
                              te.tower_epilogue(y, *tabs, residual=res)),
               "plain_ms": lambda: (te.tower_epilogue_plain(y, *tabs),
                                    te.tower_epilogue_plain(y, *tabs, res)),
               "library_ms": modules}
        runs = {k: [] for k in fns}
        with torch.inference_mode():
            for key in (*fns, *reversed(list(fns))):
                runs[key].append(device_ms(fns[key], cycles_per_ms, reps=5))
        t = {k: float(np.mean([ms for ms, _ in v])) for k, v in runs.items()}
        check(all(a for _, a in runs["ms"]),
              f"epilogue [{N}, {C}, {H}, {W}]: the host did not run ahead")
        nbytes = 5 * N * C * H * W * 4
        t.update(bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
                 shape=[N, C, H, W])
        timings[(C, H, W)] = t
        say(f"[4b epilogue] [{N}, {C}, {H}, {W}], a block's two epilogues, "
            f"device time, warm: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, modules {t['library_ms']:.4f} ms; "
            f"bound {t['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} GB), kernel at "
            f"{100 * t['bound_ms'] / t['ms']:.1f} % of it on {smi}")
        del y, tabs, res, ea, eb
        torch.cuda.empty_cache()
    del model, blocks
    torch.cuda.empty_cache()
    return max_err, timings


# phase 4c: the windows at which the tower's convolutions are checked (a
# folder chunk, a ragged tail, a short call, one window) and timed (a
# folder chunk and interactive calls of 1, 2.5 and 5 s)
CONV_CHECK_WINDOWS = (2048, 795, 37, 1)
CONV_TIME_WINDOWS = (2048, 508, 250, 98)


def tower_convs(model_cfg):
    """The main tower's k x k convolutions at one window: (name, Cin, Cout,
    k, stride, H, W) of each, H and W its input's."""
    from nhans_tpu_torch.nn.blocks import same_pads

    convs, cin = [], 1
    t, f = model_cfg.window_frames, model_cfg.num_features
    for i, (k, s, c) in enumerate(model_cfg.main_blocks):
        convs.append((f"resblock{i + 1}.conv1", cin, c, k, s, t, f))
        t, f = same_pads(t, k, s)[2], same_pads(f, k, s)[2]
        convs.append((f"resblock{i + 1}.conv2", c, c, k, 1, t, f))
        cin = c
    return convs


def conv_inputs(N, cin, cout, k, s, H, W, dev, seed):
    """Random x [N, cin, H, W], w (unit variance of the output), bias
    (conv2's; conv1 has none), stride and TF-SAME pads, float32."""
    import torch

    from nhans_tpu_torch.nn.blocks import same_pads

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, cin, H, W, generator=g, device=dev)
    w = torch.randn(cout, cin, k, k, generator=g, device=dev) / (
        cin * k * k) ** 0.5
    b = (torch.randn(cout, generator=g, device=dev) * 0.1
         if s == 1 and cin == cout else None)
    tl, th, _ = same_pads(H, k, s)
    fl, fh, _ = same_pads(W, k, s)
    return x, w, b, (s, s), (fl, fh, tl, th)


def conv_gaps(x, w, b, stride, pads, got):
    """How far ``got`` and cuDNN's float32 convolution (TF32 off) lie from
    the float64 one: (max |got - exact| over its bound, rms of got's
    error, rms of cuDNN's).  The bound is the float32 sum's worst case,
    (K + 1) u (sum |x| |w| + |b|), K = Cin k^2 products, u = 2^-24."""
    import torch
    import torch.nn.functional as F

    K = w.shape[1] * w.shape[2] * w.shape[3]
    xp = F.pad(x, pads)
    lib = F.conv2d(xp, w, b, stride=stride)
    xp = xp.double()
    exact = F.conv2d(xp, w.double(), None if b is None else b.double(),
                     stride=stride)
    mag = F.conv2d(xp.abs_(), w.double().abs(),
                   None if b is None else b.double().abs(), stride=stride)
    del xp
    bound = mag.mul_((K + 1) * 2.0 ** -24)
    over = ((got.double() - exact).abs_() / bound).max().item()
    rms = ((got.double() - exact).square_().mean().sqrt().item(),
           (lib.double() - exact).square_().mean().sqrt().item())
    del exact, bound, lib
    torch.cuda.empty_cache()
    return over, rms[0], rms[1]


def phase4c(dev, cycles_per_ms, smi):
    """The main tower's convolution kernel on the card, TF32 off.

    (a) ``ops.tower_conv`` at the 16 convolutions of the shipped tower x
        2048, 795, 37 and 1 windows: within the float32 sum's worst-case
        bound of the float64 convolution everywhere, and its rms error at
        most twice cuDNN's float32 one.
    (b) device time of each convolution at 2048, 508, 250 and 98 windows:
        the kernel (with its weight transpose), cuDNN's ``F.conv2d`` on the
        padded input (``library_ms``, as the modules run it), the plain
        version (``F.pad`` + ``F.conv2d``, the parent's path), and the
        bound (the larger of the direct FLOPs at 67 TFLOP/s and the bytes
        of input, weights and output at 3.35 TB/s); the kernel faster than
        cuDNN at every one.
    (c) the training step's 24 convolutions (``train_convs``: both towers'
        k x k ones at 64 windows) in three directions, each through the
        path the step takes (``tower_conv``; ``tower_conv.input_grad``,
        cuDNN's at a stride; ``conv_wgrad``) and cuDNN's as the modules run
        it: every value within the float32 sum's worst-case bound of the
        float64 result, the rms error at most TRAIN_CONV_RMS_X times
        cuDNN's, the weight and bias gradients bit for bit across two runs.
    (d) device time of each of (c)'s, the kernels' and cuDNN's, beside the
        direct operations at 67 TFLOP/s, and their sums over a step.
    Returns (the worst error over its bound in (a), timings, the worst in
    (c), (d)'s timings)."""
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.utils.device import full_float32

    convs = tower_convs(Config.denoiser().model)
    train = train_convs(Config.separator().model)
    with full_float32():
        return (check_tower_convs(dev, convs),
                time_tower_convs(dev, cycles_per_ms, smi, convs),
                check_train_convs(dev, train)[0],
                time_train_convs(dev, cycles_per_ms, smi, train))


def check_tower_convs(dev, convs):
    """Phase 4c (a); the worst error over its bound."""
    import torch

    from nhans_tpu_torch.ops import tower_conv as tc

    worst = 0.0
    for N in CONV_CHECK_WINDOWS:
        for i, (name, cin, cout, k, s, H, W) in enumerate(convs):
            x, w, b, stride, pads = conv_inputs(N, cin, cout, k, s, H, W, dev,
                                                N + i)
            before = tc.tower_conv.launches
            got = tc.tower_conv(x, w, b, stride, pads)
            torch.cuda.synchronize()
            check(tc.tower_conv.launches == before + 1,
                  f"tower_conv {name} x{N}: launches")
            over, rms, rms_lib = conv_gaps(x, w, b, stride, pads, got)
            worst = max(worst, over)
            check(over <= 1.0, f"tower_conv {name} x{N}: {over:.3g} times "
                  "the float32 bound from the float64 convolution")
            check(rms <= 2 * rms_lib, f"tower_conv {name} x{N}: rms error "
                  f"{rms:.3g}, cuDNN's {rms_lib:.3g}")
            if N == CONV_CHECK_WINDOWS[0] or N == 1:
                say(f"[4c conv] {name} [{N}, {cin}, {H}, {W}] k{k} s{s} -> "
                    f"{cout}: max error {over:.3g} of the bound, rms "
                    f"{rms:.3g} (cuDNN {rms_lib:.3g})")
            del x, w, b, got
            torch.cuda.empty_cache()
    return worst


def time_tower_convs(dev, cycles_per_ms, smi, convs):
    """Phase 4c (b); the timings by (convolution, windows)."""
    import torch
    import torch.nn.functional as F

    from nhans_tpu_torch.ops import tower_conv as tc
    from nhans_tpu_torch.tools.devtime import device_ms

    timings = {}
    for N in CONV_TIME_WINDOWS:
        for i, (name, cin, cout, k, s, H, W) in enumerate(convs):
            x, w, b, stride, pads = conv_inputs(N, cin, cout, k, s, H, W, dev,
                                                i)
            xp = F.pad(x, pads)
            fns = {"ms": lambda: tc.tower_conv(x, w, b, stride, pads),
                   "library_ms": lambda: F.conv2d(xp, w, b, stride=stride),
                   "plain_ms": lambda: tc.tower_conv_plain(x, w, b, stride,
                                                           pads)}
            runs = {key: [] for key in fns}
            with torch.inference_mode():
                for key in (*fns, *reversed(list(fns))):
                    runs[key].append(device_ms(fns[key], cycles_per_ms,
                                               reps=3, warmup=2))
            t = {key: float(np.mean([ms for ms, _ in v]))
                 for key, v in runs.items()}
            Ho, Wo = (tc.out_size(H, k, s, pads[2], pads[3]),
                      tc.out_size(W, k, s, pads[0], pads[1]))
            flops = 2 * N * cout * Ho * Wo * cin * k * k
            nbytes = 4 * (x.numel() + w.numel() + N * cout * Ho * Wo)
            bounds = {"flops": flops / PEAK_FP32_FLOPS,
                      "bytes": nbytes / PEAK_BYTES}
            by = max(bounds, key=bounds.get)
            t.update(bound_ms=1e3 * bounds[by], bound_by=by,
                     shape=[N, cin, H, W, cout, k, s], flops=flops,
                     bytes=nbytes)
            timings[(name, N)] = t
            say(f"[4c conv] {name} x{N} [{cin}->{cout}, {H}x{W}, k{k} s{s}], "
                f"device time: kernel {t['ms']:.4f} ms, cuDNN "
                f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({by}); kernel at "
                f"{100 * t['bound_ms'] / t['ms']:.1f} % of it, "
                f"x{t['library_ms'] / t['ms']:.2f} on cuDNN")
            check(t["ms"] < t["library_ms"], f"tower_conv {name} x{N}: "
                  f"kernel {t['ms']:.4f} ms, cuDNN {t['library_ms']:.4f} ms")
            del x, xp, w, b
            torch.cuda.empty_cache()
        total = {key: sum(timings[(c[0], N)][key] for c in convs)
                 for key in ("ms", "library_ms", "plain_ms", "bound_ms")}
        say(f"[4c conv] the 16 convolutions at {N} windows: kernel "
            f"{total['ms']:.3f} ms ({100 * total['bound_ms'] / total['ms']:.1f}"
            f" % of their bounds), cuDNN {total['library_ms']:.3f} ms, "
            f"plain {total['plain_ms']:.3f} ms, bound {total['bound_ms']:.3f}"
            f" ms on {smi}")
    return timings


# phase 4c: the training step's windows (16 utterances x 4 crops); the
# context tower runs on each window's two crops, in two calls of 64
TRAIN_WINDOWS = 64


def train_convs(model_cfg, windows=TRAIN_WINDOWS):
    """Both towers' k x k convolutions in a training step of ``windows``
    windows: (name, N, Cin, Cout, (kh, kw), (sh, sw), H, W, bias, calls)
    of each, H and W its input's, ``calls`` its runs a step (the context
    tower's 2).  The first of each tower reads the data."""
    from nhans_tpu_torch.nn.blocks import same_pads

    convs, cin = [], 1
    t, f = model_cfg.window_frames, model_cfg.num_features
    for i, (k, s, c) in enumerate(model_cfg.main_blocks):
        convs.append((f"resblock{i + 1}.conv1", windows, cin, c, (k, k),
                      (s, s), t, f, False, 1))
        t, f = same_pads(t, k, s)[2], same_pads(f, k, s)[2]
        convs.append((f"resblock{i + 1}.conv2", windows, c, c, (k, k),
                      (1, 1), t, f, True, 1))
        cin = c
    cin = 1
    t, f = model_cfg.context_frames, model_cfg.num_features
    for i, (kernel, stride, c) in enumerate(model_cfg.context_blocks):
        convs.append((f"embedding.block{i + 1}.conv1", windows, cin, c,
                      tuple(kernel), tuple(stride), t, f, False, 2))
        t, f = same_pads(t, kernel[0], stride[0])[2], same_pads(
            f, kernel[1], stride[1])[2]
        convs.append((f"embedding.block{i + 1}.conv2", windows, c, c,
                      tuple(kernel), (1, 1), t, f, True, 2))
        cin = c
    return convs


def train_conv_inputs(conv, dev, seed):
    """Random x, w (unit variance of the output), bias, stride, pads and
    an output gradient dy of unit entries, float32, for one of
    ``train_convs``."""
    import torch

    from nhans_tpu_torch.nn.blocks import same_pads
    from nhans_tpu_torch.ops import tower_conv as tc

    _, N, cin, cout, (kh, kw), (sh, sw), H, W, bias, _ = conv
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, cin, H, W, generator=g, device=dev)
    w = torch.randn(cout, cin, kh, kw, generator=g, device=dev) / (
        cin * kh * kw) ** 0.5
    b = torch.randn(cout, generator=g, device=dev) * 0.1 if bias else None
    tl, th, _ = same_pads(H, kh, sh)
    fl, fh, _ = same_pads(W, kw, sw)
    pads = (fl, fh, tl, th)
    Ho, Wo = tc.out_size(H, kh, sh, tl, th), tc.out_size(W, kw, sw, fl, fh)
    dy = torch.randn(N, cout, Ho, Wo, generator=g, device=dev)
    return x, w, b, (sh, sw), pads, dy


def _gaps(got, exact, mag, K, lib):
    """(max |got - exact| over the float32 sum's worst case (K + 1) u mag,
    rms of got's error, rms of lib's), all against the float64 result."""
    bound = mag.mul_((K + 1) * 2.0 ** -24)
    over = ((got.double() - exact).abs_() / bound).max().item()
    return (over, (got.double() - exact).square_().mean().sqrt().item(),
            (lib.double() - exact).square_().mean().sqrt().item())


def train_conv_directions(conv, x, w, b, stride, pads, dy):
    """The three directions of one training convolution: for each of
    "forward", "input" (not for a convolution that reads the data) and
    "weight", (the kernels' function, cuDNN's function as the modules run
    it, the float64 exact function, the float64 function of |inputs|, K
    products an output)."""
    import torch
    import torch.nn.functional as F

    from nhans_tpu_torch.ops import tower_conv as tc
    from nhans_tpu_torch.ops.conv_wgrad import conv_wgrad

    _, N, cin, cout, kernel, _, H, W, bias, _ = conv
    kh, kw = kernel
    pl, pr, pt, pb = pads
    xp = F.pad(x, pads)
    big = (N, cin, H + pt + pb, W + pl + pr)

    def dx(d, wt):
        return torch.nn.grad.conv2d_input(big, wt, d, stride)[
            :, :, pt:pt + H, pl:pl + W]

    def dw(xx, d):
        return torch.nn.grad.conv2d_weight(xx, w.shape, d, stride)

    out = {"forward": (
        lambda: tc.tower_conv(x, w, b, stride, pads),
        lambda: F.conv2d(xp, w, b, stride=stride),
        lambda: F.conv2d(xp.double(), w.double(),
                         None if b is None else b.double(), stride=stride),
        lambda: F.conv2d(xp.double().abs(), w.double().abs(),
                         None if b is None else b.double().abs(),
                         stride=stride),
        cin * kh * kw)}
    if cin > 1:
        out["input"] = (
            lambda: tc.input_grad(dy, w, x.shape, stride, pads),
            lambda: dx(dy, w),
            lambda: dx(dy.double(), w.double()),
            lambda: dx(dy.double().abs(), w.double().abs()),
            cout * kh * kw)
    out["weight"] = (
        lambda: conv_wgrad(x, dy, kernel, stride, pads, bias),
        lambda: (dw(xp, dy), dy.sum((0, 2, 3)) if bias else None),
        lambda: (dw(xp.double(), dy.double()),
                 dy.double().sum((0, 2, 3)) if bias else None),
        lambda: (dw(xp.double().abs(), dy.double().abs()),
                 dy.double().abs().sum((0, 2, 3)) if bias else None),
        N * dy.shape[2] * dy.shape[3])
    return out


def check_train_convs(dev, convs):
    """Phase 4c (c); the worst error over its bound, and the gaps by
    (convolution, direction)."""
    import torch

    worst, gaps = 0.0, {}
    for i, conv in enumerate(convs):
        name = conv[0]
        args = train_conv_inputs(conv, dev, 100 + i)
        for d, (mine, lib, exact, mag, K) in train_conv_directions(
                conv, *args).items():
            got, ref = mine(), lib()
            want, size = exact(), mag()
            if d == "weight":
                again = mine()
                check(torch.equal(got[0], again[0]) and (
                    got[1] is None or torch.equal(got[1], again[1])),
                    f"conv_wgrad {name}: two runs differ")
                parts = [(got[0], want[0], size[0], ref[0])]
                if got[1] is not None:
                    parts.append((got[1], want[1], size[1], ref[1]))
            else:
                parts = [(got, want, size, ref)]
            torch.cuda.synchronize()
            for j, (g, e, m, r) in enumerate(parts):
                over, rms, rms_lib = _gaps(g, e, m, K, r)
                what = f"{name} {d}" + (" (bias)" if j else "")
                gaps[what] = (over, rms, rms_lib)
                worst = max(worst, over)
                check(over <= 1.0, f"{what}: {over:.3g} times the float32 "
                      "bound from the float64 result")
                check(rms <= TRAIN_CONV_RMS_X * rms_lib + 1e-30,
                      f"{what}: rms error {rms:.3g}, cuDNN's {rms_lib:.3g}")
                say(f"[4c train] {what} [{conv[1]}, {conv[2]}, {conv[6]}, "
                    f"{conv[7]}] k{conv[4]} s{conv[5]} -> {conv[3]}: max "
                    f"error {over:.3g} of the bound, rms {rms:.3g} (cuDNN "
                    f"{rms_lib:.3g})")
            del got, ref, want, size, parts
        del args
        torch.cuda.empty_cache()
    return worst, gaps


def time_train_convs(dev, cycles_per_ms, smi, convs):
    """Phase 4c (d); device ms by (convolution, direction): the kernels'
    and cuDNN's as the modules run it, and the direct operations' bound."""
    import torch

    from nhans_tpu_torch.tools.devtime import device_ms

    timings = {}
    for i, conv in enumerate(convs):
        name = conv[0]
        args = train_conv_inputs(conv, dev, i)
        for d, (mine, lib, _, _, K) in train_conv_directions(
                conv, *args).items():
            # K products for each output: y (dy's size), dx or dw
            ops = 2 * K * {"forward": args[5], "input": args[0],
                           "weight": args[1]}[d].numel()
            fns = {"ms": mine, "library_ms": lib}
            if d == "input" and conv[5] != (1, 1):
                fns = {"library_ms": lib}       # cuDNN's in both paths
            runs = {key: [] for key in fns}
            with torch.no_grad():
                for key in (*fns, *reversed(list(fns))):
                    runs[key].append(device_ms(fns[key], cycles_per_ms,
                                               reps=3, warmup=2)[0])
            t = {key: float(np.mean(v)) for key, v in runs.items()}
            t.update(bound_ms=1e3 * ops / PEAK_FP32_FLOPS, flops=ops,
                     calls=conv[9], shape=[conv[1], conv[2], conv[6],
                                           conv[7], conv[3], list(conv[4]),
                                           list(conv[5])])
            timings[(name, d)] = t
            mine_ms = t.get("ms")
            say(f"[4c train] {name} {d} x{conv[1]} [{conv[2]}->{conv[3]}, "
                f"{conv[6]}x{conv[7]}, k{conv[4]} s{conv[5]}], device time: "
                + (f"kernel {mine_ms:.4f} ms "
                   f"({100 * t['bound_ms'] / mine_ms:.1f} % of the bound), "
                   if mine_ms is not None else "")
                + f"cuDNN {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms" + (
                    f", x{t['library_ms'] / mine_ms:.2f} on cuDNN"
                    if mine_ms is not None else ""))
        del args
        torch.cuda.empty_cache()
    for d in ("forward", "input", "weight"):
        rows = [(k, t) for k, t in timings.items() if k[1] == d]
        lib = sum(t["library_ms"] * t["calls"] for _, t in rows)
        ours = sum((t.get("ms", t["library_ms"])) * t["calls"]
                   for _, t in rows)
        bound = sum(t["bound_ms"] * t["calls"] for _, t in rows)
        say(f"[4c train] a step's {d}: kernels {ours:.3f} ms, cuDNN "
            f"{lib:.3f} ms, bound {bound:.3f} ms on {smi}")
    # the weight gradient's kernel time over the forward's, at each shape
    ratio = {name: t["ms"] / timings[(name, "forward")]["ms"]
             for (name, d), t in timings.items() if d == "weight"}
    say("[4c train] weight gradient / forward kernel time: " + ", ".join(
        f"{name} {r:.3f}" for name, r in ratio.items()) +
        f"; at or under 1 at {sum(r <= 1 for r in ratio.values())} of "
        f"{len(ratio)}")
    return timings


def hand_step(dev, model_cfg, weights, windows=TRAIN_WINDOWS, seed=23,
              modules_tf32=False):
    """One training forward and backward of the model at full width on
    ``windows`` random windows and their contexts, from ``weights``, TF32
    off: once through the hand-written training convolutions and
    epilogues and once through the modules (``nn/model.py::_train_conv``
    replaced by the module call and ``_train_epilogue`` by
    ``_epilogue_modules``; in TF32 with ``modules_tf32``), from the same
    state.  Returns
    (gradients by leaf of each, the counts of convolutions and of
    BatchNorms whose epilogues took the kernels, ms of each by CUDA
    events)."""
    import torch

    from nhans_tpu_torch.utils.device import full_float32

    from nhans_tpu_torch.nn import model as nn_model
    from nhans_tpu_torch.nn.model import (NHANSNet, freq_weighted_mse,
                                          hand_convs, hand_epilogues)

    model = NHANSNet(model_cfg)
    model.load_state_dict(weights)
    model = model.to(dev).train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    W, C, F = (model_cfg.window_frames, model_cfg.context_frames,
               model_cfg.num_features)
    mixed = torch.randn(windows, W, F, generator=g, device=dev) - 4
    ctx = [torch.randn(windows, C, F, generator=g, device=dev) - 4
           for _ in range(2)]
    target = mixed[:, W // 2] + 0.1 * torch.randn(
        windows, F, generator=g, device=dev)

    def run():
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with hand_convs() as seen, hand_epilogues() as epilogues:
            res = model(mixed, *ctx)
            loss, _ = freq_weighted_mse(mixed[:, W // 2] + res, target)
        loss.backward()
        ev[1].record()
        torch.cuda.synchronize()
        return ({k: p.grad.detach().clone()
                 for k, p in model.named_parameters()},
                (len(seen), len(epilogues)), ev[0].elapsed_time(ev[1]))

    real = nn_model._train_conv, nn_model._train_epilogue
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        with full_float32():
            run()                               # warm-up of both paths
            hand, count, hand_ms = run()
        nn_model._train_conv = lambda conv, x, fs=None: conv(x, fs)
        nn_model._train_epilogue = nn_model._epilogue_modules
        torch.backends.cudnn.allow_tf32 = modules_tf32
        torch.backends.cuda.matmul.allow_tf32 = modules_tf32
        run()
        modules, none, modules_ms = run()
    finally:
        nn_model._train_conv, nn_model._train_epilogue = real
        torch.backends.cudnn.allow_tf32 = tf32[0]
        torch.backends.cuda.matmul.allow_tf32 = tf32[1]
    check(none == (0, 0), "the modules' step sent convolutions or "
          "epilogues to the kernels")
    del model
    torch.cuda.empty_cache()
    return hand, modules, count, (hand_ms, modules_ms)


def modules_flops(fn):
    """torch's FLOP count of ``fn()`` with the training step's convolutions
    on the modules: the count sees aten's convolutions and not the
    hand-written kernels, which compute the same operations."""
    from torch.utils.flop_counter import FlopCounterMode

    from nhans_tpu_torch.nn import model as nn_model

    real = nn_model._train_conv
    nn_model._train_conv = lambda conv, x, fs=None: conv(x, fs)
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
    finally:
        nn_model._train_conv = real
    return counter.get_total_flops()


def leaf_gaps(got, want):
    """By leaf, ||got - want|| over the larger of ||want|| and the median
    leaf's, as the benchmark's check takes its gradient gap."""
    import torch

    norms = {k: torch.linalg.vector_norm(v).item() for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    return {k: torch.linalg.vector_norm(got[k] - want[k]).item()
            / max(norms[k], med) for k in want}


# phase 12: the optimizer kernel's bytes a value (gradient and parameter
# read, parameter written; Adam also reads and writes mu and nu)
OPTIMIZER_BYTES = {"sgd": 12, "adam": 28}


def optimizer_kernel(dev, cycles_per_ms, smi):
    """The optimizer kernel (csrc/optimizer_update.cu) at the separator's
    393 parameter tensors, random, one without a gradient, for sgd and
    Adam (Adam's third update, so both corrections differ from 1):

    (a) one update through ``optimizer_update`` in 2 launches, its
        parameters, mu and nu equal bit for bit to ``optimizer_update_plain``
        on clones of the same card tensors, the squared sum within 1e-6
        relative;
    (b) device time of the update, warm, against the plain version; the
        bound is OPTIMIZER_BYTES a value at the card's bandwidth.
    Returns (timings by rule, the values)."""
    import torch

    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.nn.model import NHANSNet
    from nhans_tpu_torch.ops import optimizer_update as ou
    from nhans_tpu_torch.tools.devtime import device_ms

    with torch.device("meta"):
        shapes = [p.shape for p in NHANSNet(Config().model).parameters()]
    g = torch.Generator(device=dev).manual_seed(22)

    def rand(scale, positive=False):
        return [(torch.rand if positive else torch.randn)(
            s, generator=g, device=dev) * scale for s in shapes]

    params, grads = rand(0.1), rand(1e-2)
    grads[7] = None
    values = sum(p.numel() for p in params)
    check(len(shapes) == 393 and values == 28980937,
          f"the separator has {len(shapes)} tensors, {values} values")
    c1, c2 = (float(torch.tensor(1.0) - torch.tensor(b) ** 3)
              for b in (0.9, 0.999))
    timings = {}
    for name, rule in (("sgd", ou.Rule("sgd", -1e-3)),
                       ("adam", ou.Rule("adam", -1e-3, c1=c1, c2=c2))):
        slots = (rand(1e-3), rand(1e-5, positive=True)) if name == "adam" \
            else ((), ())
        mine, ref = ([[t.clone() for t in ts] for ts in (params, *slots)]
                     for _ in range(2))
        # (a)
        ou.optimizer_update.launches = 0
        got = ou.optimizer_update(rule, mine[0], grads, *mine[1:])
        check(ou.optimizer_update.launches == 2, f"optimizer {name}: "
              f"{ou.optimizer_update.launches} launches for one update")
        want = ou.optimizer_update_plain(rule, ref[0], grads, *ref[1:])
        for what, a, b in zip(("param", "mu", "nu"), mine, ref):
            bad = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(
                x.view(torch.int32), y.view(torch.int32))]
            check(not bad, f"optimizer {name}: {what} of tensors {bad[:5]} "
                  "differ from the plain version")
        rel = abs(float(got[0]) - float(want[0])) / float(want[0])
        check(rel <= 1e-6 and float(got[1]) == 0.0, f"optimizer {name}: "
              f"squared sums {got.tolist()} against {want.tolist()}")
        # (b)
        fns = {"ms": lambda: ou.optimizer_update(rule, mine[0], grads,
                                                 *mine[1:]),
               "plain_ms": lambda: ou.optimizer_update_plain(
                   rule, ref[0], grads, *ref[1:])}
        reps = {"ms": 50, "plain_ms": 5}
        runs = {k: [] for k in fns}
        for key in (*fns, *reversed(list(fns))):
            runs[key].append(device_ms(fns[key], cycles_per_ms,
                                       reps=reps[key], warmup=2))
        t = {k: float(np.mean([ms for ms, _ in v])) for k, v in runs.items()}
        check(all(a for _, a in runs["ms"]),
              f"optimizer {name}: the host did not run ahead")
        nbytes = OPTIMIZER_BYTES[name] * values
        t.update(bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
                 norm_rel_err=rel)
        timings[name] = t
        say(f"[12 optimizer] {name}, one update of 393 tensors "
            f"({values} values; bit for bit the plain version, squared sum "
            f"within {rel:.2g}), device time, warm: kernel {t['ms']:.4f} ms,"
            f" plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
            f"({nbytes / 1e9:.3f} GB), kernel at "
            f"{100 * t['bound_ms'] / t['ms']:.1f} % of it on {smi}")
        del mine, ref, slots, got, want, fns
    del params, grads
    torch.cuda.empty_cache()
    return timings, values


def epilogue_shapes(model_cfg, windows=TRAIN_WINDOWS):
    """The 24 epilogues of a training step of ``windows`` windows, one
    after each of ``train_convs``: (name, N, C, H, W, tables, residual,
    calls) of each, H x W its convolution's output, ``tables`` for the main
    tower's conditioning, ``residual`` after a block's second convolution,
    ``calls`` its runs a step (the context tower's 2)."""
    from nhans_tpu_torch.nn.blocks import same_pads

    return [(name, N, cout, same_pads(H, kh, sh)[2], same_pads(W, kw, sw)[2],
             name.startswith("resblock"), bias, calls)
            for name, N, _, cout, (kh, kw), (sh, sw), H, W, bias, calls
            in train_convs(model_cfg, windows)]


def epilogue_inputs(shape, dev, seed):
    """Random y, residual (or None), the tables a, b [N, C], t [H, C],
    f [W, C] (or Nones), a BatchNorm in training with random gamma, beta
    and population statistics, and an output gradient, float32, for one
    of ``epilogue_shapes``."""
    import torch

    from nhans_tpu_torch.nn.blocks import BatchNorm

    _, N, C, H, W, tables, residual, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*size, scale=1.0, shift=0.0):
        return torch.randn(*size, generator=g, device=dev) * scale + shift

    y = rand(N, C, H, W, scale=2.0, shift=0.5)
    r = rand(N, C, H, W) if residual else None
    tabs = ((rand(N, C), rand(N, C), rand(H, C, scale=0.3),
             rand(W, C, scale=0.3)) if tables else (None,) * 4)
    bn = BatchNorm(C).to(dev).train()
    with torch.no_grad():
        bn.gamma.copy_(rand(C, scale=0.5, shift=1.0))
        bn.beta.copy_(rand(C, scale=0.5))
        bn.pop_mean.copy_(rand(C))
        bn.pop_variance.copy_(rand(C).abs() + 0.5)
    return y, r, tabs, bn, rand(N, C, H, W)


# phase 12: the training epilogue's least transfers of an output element
# (y in, out, dout in, the saved v in, dy out), a residual's one more
EPILOGUE_TRANSFERS = 5
# phase 12: the kernels against the plain version (the gpu test's bars):
# relative and absolute error of the output, the moments and the
# population statistics, relative by norm of each gradient
EPILOGUE_TOL = {"out": (1e-6, 1e-6), "mom": (1e-12, 1e-9),
                "stats": (1e-6, 1e-7), "grad": 1e-5}


def _within(got, want, rtol, atol):
    """The largest |got - want| over atol + rtol |want|: 1 at the bar."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def epilogue_kernels(dev, cycles_per_ms, smi):
    """Training's epilogue kernels (csrc/train_epilogue.cu) at the 24
    output shapes of a separator step of TRAIN_WINDOWS windows, random
    inputs:

    (a) the forward and backward through ``train_epilogue_forward`` and
        ``train_epilogue_backward``, one launch of each a call, twice on
        the same card tensors: equal bit for bit, the population
        statistics too; against ``train_epilogue_forward_plain`` and
        ``train_epilogue_backward_plain`` on the same tensors (sums in
        another order): v equal, the rest within EPILOGUE_TOL;
    (b) device time of the kernels' forward and of their backward, warm,
        against the plain version's forward and backward and the
        modules' (the broadcast adds, ``BatchNorm`` in training and ReLU
        under autograd, TF32 off); the bound is 4 x (5 + r) bytes an
        output element at the card's bandwidth.
    Returns (timings by shape name, with ``calls`` a step; the worst
    error of (a) over its bar, 1 at the bar)."""
    import torch

    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.ops import train_epilogue as te
    from nhans_tpu_torch.tools.devtime import device_ms
    from nhans_tpu_torch.utils.device import full_float32

    timings, worst = {}, 0.0
    for i, shape in enumerate(epilogue_shapes(Config.separator().model)):
        name, N, C, H, W, tables, residual, calls = shape
        y, r, tabs, bn, dout = epilogue_inputs(shape, dev, 240 + i)
        g, be = bn.gamma.detach(), bn.beta.detach()
        pops = [(bn.pop_mean.clone(), bn.pop_variance.clone())
                for _ in range(3)]

        def forward(pm, pv):
            return te.train_epilogue_forward(y, r, *tabs, g, be, pm, pv,
                                             bn.eps, bn.decay)

        def backward(saved):
            return te.train_epilogue_backward(dout, saved[1], saved[2], g,
                                              be, tables)

        # (a)
        runs = []
        for pm, pv in pops[:2]:
            before = (te.train_epilogue_forward.launches,
                      te.train_epilogue_backward.launches)
            fwd = forward(pm, pv)
            runs.append((fwd, backward(fwd)))
            launches = (te.train_epilogue_forward.launches - before[0],
                        te.train_epilogue_backward.launches - before[1])
            check(launches == (1, 1), f"train_epilogue {name}: {launches} "
                  "forward and backward launches for one call")
        torch.cuda.synchronize()
        (fwd, bwd), again = runs
        for x, z in zip(fwd + bwd + pops[0], again[0] + again[1] + pops[1]):
            check((x is None and z is None) or torch.equal(x, z),
                  f"train_epilogue {name}: two runs differ")
        pfwd = te.train_epilogue_forward_plain(y, r, *tabs, g, be, *pops[2],
                                               bn.eps, bn.decay)
        pbwd = te.train_epilogue_backward_plain(dout, pfwd[1], pfwd[2], g,
                                                be, tables)
        check(torch.equal(fwd[1], pfwd[1]), f"train_epilogue {name}: v "
              "differs from the plain version")
        gaps = {"out": _within(fwd[0], pfwd[0], *EPILOGUE_TOL["out"]),
                "mom": _within(fwd[2], pfwd[2], *EPILOGUE_TOL["mom"]),
                "stats": max(_within(x, z, *EPILOGUE_TOL["stats"])
                             for x, z in zip(pops[0], pops[2]))}
        for what, x, z in zip(("dy", "da", "dt", "df", "dgamma", "dbeta"),
                              bwd, pbwd):
            check((x is None) == (z is None), f"train_epilogue {name}: "
                  f"{what} on one side only")
            if z is not None:
                scale = max(torch.linalg.vector_norm(z).item(),
                            z.abs().max().item(), 1e-30)
                gaps[what] = (torch.linalg.vector_norm(x - z).item()
                              / (EPILOGUE_TOL["grad"] * scale))
        at = max(gaps, key=gaps.get)
        check(gaps[at] <= 1.0, f"train_epilogue {name}: {at} at "
              f"{gaps[at]:.3g} of its bar from the plain version")
        worst = max(worst, gaps[at])
        del runs, again, pfwd, pbwd
        # (b)
        leaves = [x if x is None else x.clone().requires_grad_()
                  for x in (y, r) + tuple(tabs)]

        def modules():
            for x in leaves:
                if x is not None:
                    x.grad = None
            bn.zero_grad(set_to_none=True)
            yl, rl, a, b, t_, f = leaves
            v = yl
            if a is not None:
                v = (v + a[:, :, None, None] + b[:, :, None, None]
                     + t_.t()[None, :, :, None] + f.t()[None, :, None, :])
            if rl is not None:
                v = v + rl
            torch.relu(bn(v)).backward(dout)

        def plain():
            p = te.train_epilogue_forward_plain(y, r, *tabs, g, be, *pops[2],
                                                bn.eps, bn.decay)
            te.train_epilogue_backward_plain(dout, p[1], p[2], g, be, tables)

        fns = {"forward_ms": lambda: forward(*pops[0]),
               "backward_ms": lambda: backward(fwd),
               "plain_ms": plain, "library_ms": modules}
        reps = {"forward_ms": 20, "backward_ms": 20, "plain_ms": 3,
                "library_ms": 10}
        t = {}
        with full_float32():
            for key, fn in fns.items():
                t[key], ahead = device_ms(fn, cycles_per_ms, reps=reps[key],
                                          warmup=2)
                check(ahead or key == "plain_ms", f"train_epilogue {name} "
                      f"{key}: the host did not run ahead")
        t["ms"] = t["forward_ms"] + t["backward_ms"]
        nbytes = 4 * (EPILOGUE_TRANSFERS + residual) * y.numel()
        t.update(bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
                 calls=calls, shape=[N, C, H, W, int(tables), int(residual)],
                 err=gaps[at])
        timings[name] = t
        say(f"[12 epilogue] {name} [{N}, {C}, {H}, {W}] tables {tables:d} "
            f"residual {residual:d}: two runs bit for bit, worst "
            f"{gaps[at]:.3g} of the bar ({at}) from the plain version; "
            f"device ms, warm: forward {t['forward_ms']:.4f}, backward "
            f"{t['backward_ms']:.4f}, plain {t['plain_ms']:.4f}, modules "
            f"{t['library_ms']:.4f}; bound {t['bound_ms']:.4f} "
            f"({100 * t['bound_ms'] / t['ms']:.1f} % of it)")
        del y, r, tabs, bn, dout, fwd, bwd, leaves, fns
        torch.cuda.empty_cache()
    step = {k: sum(t[k] * t["calls"] for t in timings.values())
            for k in ("forward_ms", "backward_ms", "ms", "plain_ms",
                      "library_ms", "bound_ms")}
    say(f"[12 epilogue] a step's 32 epilogue calls ({TRAIN_WINDOWS} windows, "
        f"the context tower's twice), device ms: kernels {step['ms']:.3f} "
        f"(forward {step['forward_ms']:.3f}, backward "
        f"{step['backward_ms']:.3f}), {100 * step['bound_ms'] / step['ms']:.1f}"
        f" % of the bound {step['bound_ms']:.3f}; plain {step['plain_ms']:.3f};"
        f" modules {step['library_ms']:.3f}; worst error {worst:.3g} of its "
        f"bar; on {smi}")
    return timings, worst


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
    from nhans_tpu_torch.ops.conv_wgrad import conv_wgrad
    from nhans_tpu_torch.ops.tower_conv import tower_conv
    from nhans_tpu_torch.ops.tower_epilogue import tower_epilogue
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
              ((8, 256000), True), ((2, 32240), False), ((1, 52000), True),
              ((1, 48000), True), ((16, 160000), True), ((32, 32240), False),
              ((16, 63920), False), ((1, 96000), True), ((8, 96000), True),
              ((8, 512000), True), ((1, 42000), False)]
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
                            (8, 163600, False), (8, 256000, True),
                            (1, 52000, True), (1, 48000, True),
                            (1, 42000, False)):
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

    # -- 4b, 4c. the main tower's epilogue and convolution kernels ----------
    for name in ("tower_epilogue", "tower_conv", "conv_wgrad"):
        _, record = _build.load(name)
        say(f"[4b build] {os.path.relpath(record['path'], REPO)} in "
            f"{record['seconds']:.2f} s")
        for line in record["ptxas"]:
            say(f"  {line}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            check(spills is None or spills.groups() == ("0", "0"),
                  f"ptxas reports spills: {line}")
    epilogue_err, epilogue_timings = phase4b(dev, cycles_per_ms, smi)
    conv_err, conv_timings, train_conv_err, train_conv_timings = phase4c(
        dev, cycles_per_ms, smi)

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
    tower_epilogue.launches = tower_conv.launches = 0
    forwards = []      # each tower forward enters its first block once
    hook = den.model.resblock1.register_forward_hook(
        lambda m, i, o: forwards.append(i[0].shape[0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = den.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    wall_first = time.perf_counter() - t0
    hook.remove()
    serving_launches = stft_cuda.log_spectrogram_kernel.launches
    epilogue_launches = tower_epilogue.launches
    conv_launches = tower_conv.launches
    blocks = len(den.cfg.model.main_blocks)
    say(f"[5 denoiser] main path: {serving_launches} kernel launches "
        "(contexts [8, 32240] and mixed [4, 160000]); "
        f"{epilogue_launches} epilogue and {conv_launches} convolution "
        f"launches in {len(forwards)} tower forwards of {forwards} windows")
    check(serving_launches == 2,
          f"expected 2 kernel launches, saw {serving_launches}")
    for what, n in (("epilogue", epilogue_launches),
                    ("convolution", conv_launches)):
        check(len(forwards) > 0 and n == 2 * blocks * len(forwards),
              f"expected {2 * blocks} {what} launches in each of "
              f"{len(forwards)} tower forwards, saw {n}")
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
        # phase 16 serves the same input from the TF-converted weights
        p7 = {"in": np.rint(mixed[1]).astype(np.int16),
              "neg": np.rint(neg).astype(np.int16),
              "out": {tag: wavfile.read(os.path.join(tmp, f"out{tag}.wav"))[1]
                      for tag in ("", "_mixed_processed", "_removed",
                                  "_compensated")}}
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
        flops = modules_flops(lambda: trainer.step_fn(
            trainer.state, dbanks.banks, idx, step_generator(0, 0)))
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
        # the optimizer and epilogue kernels, remat, the padded tower -------
        from nhans_tpu_torch.ops import train_epilogue as te
        from nhans_tpu_torch.ops.optimizer_update import optimizer_update
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

        opt_launches, conv_step_launches, epi_step_launches = {}, {}, {}

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
                n_flops = modules_flops(lambda: step_fn(
                    state, dbanks.banks, idxs[1], step_generator(0, 1)))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stft_cuda.log_spectrogram_kernel.launches = 0
            optimizer_update.launches = 0
            conv_launches = (tower_conv.launches, conv_wgrad.launches)
            te.train_epilogue_forward.launches = 0
            te.train_epilogue_backward.launches = 0
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
            # the training kernels a float32 step: the forward of the 16
            # main-tower and 2 x 8 context-tower convolutions and the input
            # gradient of 12 + 2 x 5 of them; the weight gradient of 32
            conv_launches = (tower_conv.launches - conv_launches[0],
                             conv_wgrad.launches - conv_launches[1])
            conv_step_launches[name] = conv_launches
            # and the epilogue after each of the 32 convolutions' calls, one
            # forward and one backward call each
            epi_launches = (te.train_epilogue_forward.launches,
                            te.train_epilogue_backward.launches)
            epi_step_launches[name] = epi_launches
            if model == {"compute_dtype": "float32"}:
                check(conv_launches == (54 * steps, 32 * steps),
                      f"{name}: {conv_launches} training convolution "
                      f"launches in {steps} steps")
                check(epi_launches == (32 * steps, 32 * steps),
                      f"{name}: {epi_launches} training epilogue forward "
                      f"and backward calls in {steps} steps")
            elif model.get("compute_dtype") == "bfloat16":
                check(conv_launches == (0, 0), f"{name}: {conv_launches} "
                      "training convolution launches in bfloat16")
                check(epi_launches == (0, 0), f"{name}: {epi_launches} "
                      "training epilogue calls in bfloat16")
            # sgd and Adam: one update and one sum of squares a step
            opt_launches[alg] = optimizer_update.launches
            check(opt_launches[alg] == 2 * steps, f"{name}: "
                  f"{opt_launches[alg]} optimizer kernel launches in {steps}"
                  " steps")
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
        opt_timings, opt_values = optimizer_kernel(dev, cycles_per_ms, smi)
        epi_timings, epi_err = epilogue_kernels(dev, cycles_per_ms, smi)

        # the float32 step's gradients through the training kernels against
        # the modules' (cuDNN, TF32 off), and the modules' in TF32
        sep_weights = load_npz(SEPARATOR_NPZ)
        hand, modules, hand_count, step_ms = hand_step(
            dev, Config.separator().model, sep_weights)
        tf32 = hand_step(dev, Config.separator().model, sep_weights,
                         modules_tf32=True)[1]
        gaps = leaf_gaps(hand, modules)
        gaps_tf32 = leaf_gaps(tf32, modules)
        worst = max(gaps, key=gaps.get)
        check(hand_count == (24, 24), f"{hand_count[0]} convolutions and "
              f"{hand_count[1]} epilogues took the training kernels, not 24 "
              "of each")
        check(gaps[worst] <= STEP_GRAD_GAP, f"training kernels' gradient "
              f"of {worst}: {gaps[worst]:.3g} from the modules'")
        say(f"[12 hand step] separator, 64 windows, shipped weights: "
            f"{hand_count[0]} convolutions and {hand_count[1]} epilogues on "
            "the training kernels; forward "
            f"and backward {step_ms[0]:.1f} ms, modules {step_ms[1]:.1f} ms "
            f"(CUDA events); gradients against the modules' by leaf: worst "
            f"{gaps[worst]:.3g} ({worst}), median "
            f"{np.median(list(gaps.values())):.3g}; the modules in TF32: "
            f"worst {max(gaps_tf32.values()):.3g}, median "
            f"{np.median(list(gaps_tf32.values())):.3g}; on {smi}")
        del hand, modules, tf32, sep_weights
        torch.cuda.empty_cache()

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

        # -- 16. model preparation and the checkpoint tools --------------
        p16 = phase16(tmp, corpus, smi, banked_losses, p7,
                      (den, mixed, pos, neg))

        # -- 18. the installed package ----------------------------------------
        p18 = phase18(tmp, corpus, smi, p7)

        # -- 19. the JAX package's Orbax checkpoints ------------------------------
        p19 = phase19(tmp, smi, p7)

        # -- 20. the port's Orbax checkpoints at full width ---------------------
        p20 = phase20(tmp, corpus, smi, p7)
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
             p15["launches"], [(8, 163600)]),
            ("serving, converted TF checkpoint", (1, 52000, True),
             p16["conv_launches"], [(2, 32240), (1, 52000)]),
            ("validate_demo", (1, 48000, True), p16["vd_launches"],
             [(2, 32240), (1, 48000)]),
            ("installed package", (1, 52000, True), p18["launches"],
             [(2, 32240), (1, 52000)]),
            ("serving, Orbax checkpoint", (1, 52000, True),
             p19["serve_launches"], [(2, 32240), (1, 52000)]),
            ("training, resumed from Orbax", (1, 42000, False),
             p19["step_launches"], [(1, 42000)]),
            ("training, Orbax write and resume", (16, 163600, False),
             p20["train_launches"], [(16, 163600)]),
            ("serving, Orbax step directory", (1, 52000, True),
             p20["serve_launches"], [(2, 32240), (1, 52000)])):
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
        if path == "serving, converted TF checkpoint":
            check(sorted(set(p16["conv_shapes"])) == [((1, 52000), True),
                                                      ((2, 32240), False)],
                  f"converted serving shapes {p16['conv_shapes']}")
            kernels[-1]["note"] = (
                "launches: cli.denoiser --checkpoint on the variables "
                "directory cli.load_denoiser made from a TF bundle of the "
                "shipped weights (phase 16 (a)), contexts [2, 32240] and "
                "mixed [1, 52000]; times: phase 4 at the mixed shape")
        if path == "validate_demo":
            check(sorted(set(p16["vd_shapes"])) == [((1, 48000), True),
                                                    ((2, 32240), False)],
                  f"validate_demo shapes {p16['vd_shapes']}")
            kernels[-1]["note"] = (
                "launches: tools/validate_demo scoring one denoising and "
                "one separation example of 3 s with the shipped weights "
                "(phase 16 (d)), contexts [2, 32240] and mixed [1, 48000] "
                "each; times: phase 4 at the mixed shape")
        if path == "installed package":
            kernels[-1]["note"] = (
                "launches: T/bin/nhans_torch_denoiser of pip install --target "
                "T, serving phase 7's input with the kernel that nvcc built "
                "from T's csrc/ under HOME/.cache/nhans_tpu_torch/build "
                "(phase 18), contexts [2, 32240] and mixed [1, 52000]; "
                "times: phase 4 at the mixed shape")
        if path == "serving, Orbax checkpoint":
            check(sorted(set(p19["serve_shapes"])) == [((1, 52000), True),
                                                       ((2, 32240), False)],
                  f"Orbax serving shapes {p19['serve_shapes']}")
            kernels[-1]["note"] = (
                "launches: the serving command line (model narrowed to the "
                "fixture's widths) with --checkpoint tests/data/orbax/"
                "variables, an Orbax directory of the JAX package read by "
                "compat/orbax.py (phase 19 (a)), contexts [2, 32240] and "
                "mixed [1, 52000]; times: phase 4 at the mixed shape")
        if path == "training, resumed from Orbax":
            check(sorted(set(p19["step_shapes"])) == [((1, 42000), False)],
                  f"resumed step shapes {p19['step_shapes']}")
            kernels[-1]["note"] = (
                "launches: the next step of cli.train's Trainer with "
                "--restore_path tests/data/orbax/run --alg adam (phase 19 "
                "(b)), one utterance x 2 crops; times: phase 4 at the same "
                "shape")
        if path == "training, Orbax write and resume":
            kernels[-1]["note"] = (
                "launches: cli.train --alg adam --lr_schedule cosine at full "
                "width, 3 steps saving Orbax steps 2 and 3, then a fresh "
                "Trainer auto-resumed at step 2 taking step 3 (phase 20 (a), "
                "(c)); times: phase 4 at the same shape")
        if path == "serving, Orbax step directory":
            check(sorted(set(p20["serve_shapes"])) == [((1, 52000), True),
                                                       ((2, 32240), False)],
                  f"Orbax step serving shapes {p20['serve_shapes']}")
            kernels[-1]["note"] = (
                "launches: cli.denoiser --checkpoint on the Orbax step "
                "directory the port's trainer wrote at full width (phase 20 "
                "(d)), contexts [2, 32240] and mixed [1, 52000]; times: "
                "phase 4 at the mixed shape")
        if path == "training, bfloat16":
            kernels[-1]["note"] = (
                "launches: the 21 steps of cli.train --dtype bfloat16 "
                "(phase 14); times: phase 4 at the same shape, as the "
                "kernel is float32 in every compute dtype")
    for (C, H, W), t in epilogue_timings.items():
        kernels.append({
            "name": f"tower_epilogue (serving, {C}x{H}x{W})",
            "route": "cuda",
            "source": "nhans_tpu_torch/csrc/tower_epilogue.cu",
            "replaces": "nhans_tpu/nn/model.py:153",
            "launches": epilogue_launches,
            "max_abs_err": epilogue_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "note": (
                "launches: phase 5's serving call, all blocks; times: phase "
                "4b, one block's two epilogues (conv1's, conv2's with the "
                "residual) at a 2048-window chunk; library_ms: the block's "
                "modules (Inject with its projections and position MLPs, "
                "BatchNorm, ReLU), the eager passes the kernel replaces; "
                "max_abs_err: against the plain version over phase 4b (a)")})
    for (name, N), t in conv_timings.items():
        kernels.append({
            "name": f"tower_conv (serving, {name}, {N} windows)",
            "route": "cuda",
            "source": "nhans_tpu_torch/csrc/tower_conv.cu",
            "replaces": "cuDNN's float32 convolution (no TPU kernel)",
            "launches": conv_launches,
            "max_abs_err": conv_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "note": (
                "launches: phase 5's serving call, all blocks; times: phase "
                "4c, [N, Cin, H, W, Cout, k, stride]; library_ms: cuDNN's "
                "F.conv2d on the padded input, TF32 off; plain_ms: F.pad + "
                "F.conv2d; max_abs_err: the worst error over phase 4c (a)'s "
                "float32 bound (a ratio, 1 = at the bound)")})
    for (name, d), t in train_conv_timings.items():
        if "ms" not in t:
            continue                  # a strided input gradient: cuDNN's
        wgrad = d == "weight"
        kernels.append({
            "name": (f"{'conv_wgrad' if wgrad else 'tower_conv'} (training, "
                     f"{name}, {d})"),
            "route": "cuda",
            "source": (f"nhans_tpu_torch/csrc/"
                       f"{'conv_wgrad' if wgrad else 'tower_conv'}.cu"),
            "replaces": "cuDNN's float32 convolution (no TPU kernel)",
            "launches": conv_step_launches["float32 sgd"][int(wgrad)],
            "max_abs_err": train_conv_err,
            "ms": t["ms"], "plain_ms": None,
            "bound_ms": t["bound_ms"], "bound_by": "operations",
            "library_ms": t["library_ms"], "shape": t["shape"],
            "note": (
                f"launches: phase 12's last {STEP_RUNS} timed float32 sgd "
                "steps, all training convolutions of the kernel (54 "
                "tower_conv and 32 conv_wgrad a step); times: phase 4c (d), "
                "[N, Cin, H, W, Cout, kernel, stride], 64 windows (the "
                "context tower's run twice a step); library_ms: cuDNN's "
                "float32 function as the modules run it, TF32 off; "
                "max_abs_err: the worst error over phase 4c (c)'s float32 "
                "bound (a ratio, 1 = at the bound)")})
    for name, t in opt_timings.items():
        kernels.append({
            "name": f"optimizer_update (training, {name})",
            "route": "cuda",
            "source": "nhans_tpu_torch/csrc/optimizer_update.cu",
            "replaces": "none: the JAX package leaves the optimizer to XLA",
            "launches": opt_launches[name],
            "max_abs_err": 0.0,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": [393, opt_values],
            "note": (
                f"launches: phase 12's last {STEP_RUNS} timed full-width "
                f"{name} steps (update and sum of squares, 2 a step); times: "
                "phase 12, one update of the separator's 393 tensors, "
                f"{OPTIMIZER_BYTES[name]} bytes a value; plain_ms: "
                "optimizer_update_plain, per tensor, paced by the host; "
                "max_abs_err: params, mu and nu against the plain version "
                f"(bit for bit); the squared sum within "
                f"{t['norm_rel_err']:.2g} relative")})
    for name, t in epi_timings.items():
        kernels.append({
            "name": f"train_epilogue (training, {name})",
            "route": "cuda",
            "source": "nhans_tpu_torch/csrc/train_epilogue.cu",
            "replaces": "none: the JAX package leaves BatchNorm and the "
                        "conditioning to XLA",
            "launches": sum(epi_step_launches["float32 sgd"]),
            "max_abs_err": t["err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            "note": (
                f"launches: phase 12's last {STEP_RUNS} timed float32 sgd "
                "steps, forward and backward calls (32 of each a step); "
                "times: phase 12, one call's forward "
                f"({t['forward_ms']:.4f}) and backward "
                f"({t['backward_ms']:.4f}), [N, C, H, W, tables, residual] "
                f"at {TRAIN_WINDOWS} windows, {t['calls']} calls a step; "
                "plain_ms: train_epilogue_forward_plain and _backward_plain "
                "on the card; library_ms: the modules' adds, BatchNorm in "
                "training and ReLU under autograd, TF32 off; max_abs_err: "
                "the worst error against the plain version over its bar "
                "(a ratio, 1 = at the bar)")})
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
