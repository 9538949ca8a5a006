"""Where one warm denoiser call spends its time on the card.

    python -m nhans_tpu_torch.tools.profile_serving \
        --checkpoint docs/quality/denoiser_q5_swa.npz [--seconds 10]

serves a seeded utterance once to warm up (the contexts are then cached,
as in steady serving), then once under ``torch.profiler``, and prints the
tower's FLOPs per window (``FlopCounterMode``, conv + matmul), the rate
the call achieves, the summed kernel time against the wall time, and the
kernels with the most device time, beside the card's name and power
limit.  It asserts nothing; ``chip_smoke.py`` checks the outputs.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from nhans_tpu_torch.cli._app import load_enhancer
from nhans_tpu_torch.config import Config

# CUPTI reports its own buffer handling as rows of device time
_CUPTI_ROWS = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True, help="denoiser .npz")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    enh = load_enhancer(Config.denoiser(), args.checkpoint, device="cuda")
    sr = enh.cfg.audio.sample_rate
    rng = np.random.default_rng(args.seed)
    t = np.arange(int(args.seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(170 + 30 * np.sin(np.pi * t)) / sr
    mixed = (7000 * sum(np.sin(h * phase) / h for h in range(1, 6))
             + rng.standard_normal(len(t)) * 1500)
    pos = rng.standard_normal(int(0.8 * sr)) * 600
    neg = rng.standard_normal(3 * sr) * 2000

    m = enh.cfg.model
    win = torch.zeros((1, m.window_frames, m.num_features), device="cuda")
    emb = torch.zeros((1, m.context_blocks[-1][2]), device="cuda")
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        enh.model(win, emb_a=emb, emb_b=emb)
    per_window = counter.get_total_flops()
    windows = enh.cfg.audio.num_frames(len(mixed))

    enh.enhance(mixed, pos, neg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enh.enhance(mixed, pos, neg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: operator rows repeat their kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in _CUPTI_ROWS
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / 1e3  # us -> ms
    print(f"one warm {args.seconds:g} s call: tower {per_window / 1e9:.3f} "
          f"GFLOP per window x {windows} windows in {wall:.3f} s = "
          f"{per_window * windows / wall / 1e12:.2f} TFLOP/s; summed kernel "
          f"time {busy:.1f} ms against {1e3 * wall:.1f} ms wall under the "
          f"profiler, {sum(e.count for e in rows)} kernel launches, on {smi}")
    for e in rows[:args.top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms {100 * ms / max(busy, 1e-9):5.1f}%  "
              f"x{e.count:<6d} {e.key[:100]}")


if __name__ == "__main__":
    main()
