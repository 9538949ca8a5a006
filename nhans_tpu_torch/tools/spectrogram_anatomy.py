"""Where the spectrogram kernel's time goes on the card.

    python -m nhans_tpu_torch.tools.spectrogram_anatomy

builds ``csrc/log_spectrogram.cu``, prints what ptxas reports (registers,
shared memory, spills) and the kernel's SASS instructions by phase, split
at its barriers (``cuobjdump -sass``), then times by device time, warm and
cold L2, at the serving shapes and at [64, 160000], where the grid fills
the card many times over: the kernel, PyTorch's fill of the same outputs
(the time this card takes to write them alone, launch included) and the
byte bound.  It asserts nothing; ``chip_smoke.py`` checks the kernel.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from nhans_tpu_torch.dsp import spectral as sp
from nhans_tpu_torch.ops import _build, stft_cuda
from nhans_tpu_torch.tools.devtime import device_ms, sleep_cycles_per_ms

PEAK_BYTES = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
PHASES = ("tables and span", "stage 1, radix 5", "stage 2, radix 5",
          "stage 3, radix 8", "real split and log-magnitude", "store")
SHAPES = ((1, 160000, True), (4, 160000, True), (8, 160000, True),
          (8, 32240, False), (64, 160000, True))


def sass_phases(lib_path: str):
    """Static SASS instruction counts of the library's kernel between its
    barriers, and after its last EXIT (out-of-line slow paths); None
    without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    ops = [m.group(1) for m in
           (re.match(r"\s+/\*[0-9a-f]{4}\*/\s+([^;]*);", ln)
            for ln in sass.splitlines()) if m]
    ops = [op for op in ops if not op.startswith("NOP")]
    last_exit = max(i for i, op in enumerate(ops) if "EXIT" in op)
    counts = [0]
    for op in ops[:last_exit + 1]:
        counts[-1] += 1
        if "BAR.SYNC" in op:
            counts.append(0)
    return counts, len(ops) - last_exit - 1


def report(record, seed) -> None:
    """Print the build, the SASS phases and the timings of the kernel."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for line in record["ptxas"]:
        if "registers" in line or "spill" in line:
            print(line.strip())
    phases = sass_phases(record["path"])
    if phases is None:
        print("SASS: cuobjdump not found")
    else:
        counts, tail = phases
        names = PHASES if len(counts) == len(PHASES) else [
            f"phase {i}" for i in range(len(counts))]
        print("SASS instructions (static) by phase: "
              + ", ".join(f"{n} {c}" for n, c in zip(names, counts))
              + f"; out of line {tail}")

    rng = np.random.default_rng(seed)
    cycles_per_ms = sleep_cycles_per_ms()
    for B, L, with_reim in SHAPES:
        x = torch.from_numpy((rng.standard_normal((B, L)) * 0.3)
                             .astype(np.float32)).to("cuda")
        F = sp.num_frames(L)
        outs = 3 if with_reim else 1
        nbytes = 4 * (B * L + outs * B * F * 201)
        buf = torch.empty((outs, B, F, 201), device="cuda")

        def kernel():
            stft_cuda.log_spectrogram_kernel(x, with_reim)

        warm = device_ms(kernel, cycles_per_ms)[0]
        cold = device_ms(kernel, cycles_per_ms, cold=True)[0]
        fill = device_ms(lambda: buf.fill_(0.0), cycles_per_ms)[0]
        bound = 1e3 * nbytes / PEAK_BYTES
        print(f"[{B}, {L}] {'with re/im' if with_reim else 'log-only'} "
              f"(F={F}): kernel {warm:.4f} ms warm L2, {cold:.4f} ms cold "
              f"L2; fill of the outputs {fill:.4f} ms; bound {bound:.5f} ms "
              f"({nbytes / 1e6:.2f} MB): kernel at {100 * bound / warm:.1f} % "
              f"warm, {100 * bound / cold:.1f} % cold; on {smi}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    _, record = _build.load("log_spectrogram")
    report(record, args.seed)


if __name__ == "__main__":
    main()
