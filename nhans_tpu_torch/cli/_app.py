"""Shared machinery of the serving command lines (the port of
``nhans_tpu/cli/_app.py``).

    python -m nhans_tpu_torch.cli.denoiser --checkpoint docs/quality/denoiser_q5_swa.npz \\
        --input mixed.wav --neg noise.wav --output out.wav
    python -m nhans_tpu_torch.cli.separator --checkpoint docs/quality/separator_q5_swa.npz \\
        --input mixed.wav --pos target.wav --neg interference.wav --output out.wav

Next to the output it writes ``<out>_mixed_processed.wav`` and
``<out>_removed.wav``, and for the denoiser ``<out>_compensated.wav`` and
the SNR estimate on standard output.  ``--input`` may be a directory:
its wavs are enhanced in batches of 8 into the ``--output`` directory.
``--mesh auto`` splits each batch's rows over the largest power of two
of visible cards (``Enhancer(devices=...)``); with one card it serves
unsplit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from nhans_tpu_torch.config import Config, add_inference_flags
from nhans_tpu_torch.dsp import mixing as mx
from nhans_tpu_torch.utils import wavio
from nhans_tpu_torch.utils.device import resolve_device


def _sidecar(path: str, tag: str) -> str:
    base, ext = os.path.splitext(path)
    return f"{base}_{tag}{ext or '.wav'}"


def _freq_pad(num_features: int) -> int:
    """``NHANS_FREQ_PAD``: a value above ``num_features`` serves with the
    lane-padded main tower (``ModelConfig.freq_pad_to``), whose outputs
    are those of the native geometry; up to ``num_features`` (or unset)
    the native geometry, as in the JAX package.  A value that is not an
    integer is refused with a message, not a traceback."""
    val = os.environ.get("NHANS_FREQ_PAD", "").strip()
    try:
        pad = int(val or 0)
    except ValueError:
        sys.exit(f"NHANS_FREQ_PAD={val!r} is not an integer; unset it or "
                 "set it to 0")
    return pad if pad > num_features else 0


def mesh_devices(mesh: str, device) -> list:
    """The serving devices of ``--mesh``: for ``auto`` on a card, the
    largest power of two of visible cards when that is more than one (the
    choice printed on stderr); else ``[device]``."""
    device = torch.device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if mesh != "auto" or n < 2:
        return [device]
    n = 1 << (n.bit_length() - 1)
    print(f"serving sharded over {n} devices", file=sys.stderr)
    return [torch.device("cuda", i) for i in range(n)]


def load_enhancer(cfg: Config, checkpoint: str, window_chunk: int = 2048,
                  buckets_seconds=None, device="cuda", devices=None):
    """An ``Enhancer`` for ``cfg`` with the weights of a flat ``.npz``, on
    ``device`` or split over ``devices``."""
    from nhans_tpu_torch.compat.weights import load_npz
    from nhans_tpu_torch.infer.enhance import DEFAULT_BUCKETS_SECONDS, Enhancer

    return Enhancer(cfg, load_npz(checkpoint), window_chunk=window_chunk,
                    buckets_seconds=buckets_seconds or DEFAULT_BUCKETS_SECONDS,
                    device=device, devices=devices)


def _read(path: str, fs: int) -> np.ndarray:
    return wavio.read_for_processing(path, fs)


def _silent(fs: int) -> np.ndarray:
    """Implicit positive context for plain denoising: one second of
    silence."""
    return np.zeros(fs, np.float64)


def demo_mix(cfg: Config, task: str, clean: np.ndarray, pos: np.ndarray,
             neg: np.ndarray) -> np.ndarray:
    """--demo: mix the clean input with the contexts at 0 dB first (the
    reference's apply_demo).  Returns an int16-scale float64 signal, as
    the Enhancer expects: the mixers normalise to a peak of 1, so the
    mixture is scaled back by 32767."""
    c = clean / (np.max(np.abs(clean)) + 1e-6)
    n = cfg.audio.trim_to_whole_frames(len(c))
    c = torch.as_tensor(c[:n], dtype=torch.float32)
    ng = torch.as_tensor(np.resize(neg / (np.max(np.abs(neg)) + 1e-6), n),
                         dtype=torch.float32)
    if task == "denoiser":
        p = torch.as_tensor(np.resize(pos / (np.max(np.abs(pos)) + 1e-6), n),
                            dtype=torch.float32)
        mixed = mx.mix_two_noise(c, p, ng, n, n, n, 0.0, 0.0)[0]
    else:
        mixed = mx.mix_one_noise(c, ng, n, n, 0.0)[2]
    return mixed.numpy().astype(np.float64) * 32767.0


def run(task: str, argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog=f"python -m nhans_tpu_torch.cli.{task}",
        description=f"N-HANS {task} (PyTorch / CUDA)")
    add_inference_flags(parser, task=task)
    args = parser.parse_args(argv)
    base = Config.denoiser() if task == "denoiser" else Config.separator()
    pad = _freq_pad(base.model.num_features)
    if not args.checkpoint:
        sys.exit(f"--checkpoint is required: a flat .npz of weights, e.g. "
                 f"docs/quality/{task}_q5_swa.npz")
    cfg = base.replace(
        audio=dataclasses.replace(
            base.audio, recon_residual_cap=args.recon_residual_cap),
        model=dataclasses.replace(base.model, freq_pad_to=pad))
    fs = args.Fs

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        sys.exit(f"error: {err}")
    enhancer = load_enhancer(cfg, args.checkpoint,
                             devices=mesh_devices(args.mesh, device))

    if os.path.isdir(args.input):
        inputs = wavio.list_wavs(args.input)
        if not inputs:
            sys.exit(f"no wavs under {args.input}")
        os.makedirs(args.output, exist_ok=True)
        outputs = [os.path.join(args.output, os.path.basename(p))
                   for p in inputs]
    else:
        inputs, outputs = [args.input], [args.output]

    pos = (_read(args.pos, fs) if args.pos and os.path.exists(args.pos)
           else _silent(fs))
    neg = _read(args.neg, fs)

    # Context slot order differs per task (see NHANSNet): the denoiser
    # takes (pos noise, neg noise), the separator takes (interference
    # speaker = --neg, target speaker = --pos).
    if task == "denoiser":
        ctx_a, ctx_b = pos, neg
    else:
        ctx_a, ctx_b = neg, pos

    # inputs beyond the largest bucket go through the exact segmented path
    long_threshold = enhancer.buckets[-1]

    def run_batch(waves):
        if len(waves) == 1 and len(waves[0]) > long_threshold:
            r = enhancer.enhance_long(waves[0], ctx_a, ctx_b)
            return {k: ([v] if not isinstance(v, float) else np.array([v]))
                    for k, v in r.items()}
        return enhancer.enhance_batch(
            waves, [ctx_a] * len(waves), [ctx_b] * len(waves))

    def read_input(path: str) -> np.ndarray:
        x = _read(path, fs)
        return demo_mix(cfg, task, x, pos, neg) if args.demo else x

    batch = 8 if len(inputs) > 1 else 1
    for i in range(0, len(inputs), batch):
        chunk_in = inputs[i:i + batch]
        res = run_batch([read_input(p) for p in chunk_in])
        for j, out_path in enumerate(outputs[i:i + batch]):
            den = res["denoised"][j]
            mix = res["mixed_processed"][j]
            rem = res["removed"][j]
            snr_est = float(res["snr_est"][j])
            wavio.write_wav(out_path, den, fs)
            wavio.write_wav(_sidecar(out_path, "mixed_processed"), mix, fs)
            wavio.write_wav(_sidecar(out_path, "removed"), rem, fs)
            if task == "denoiser":
                print(snr_est)
                comp = enhancer.compensate(den, rem, snr_est,
                                           args.compensate, args.ac)
                wavio.write_wav(_sidecar(out_path, "compensated"), comp, fs)
            print(f"{chunk_in[j]} -> {out_path}")
