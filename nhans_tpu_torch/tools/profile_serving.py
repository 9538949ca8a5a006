"""Where one warm denoiser call spends its time on the card.

    python -m nhans_tpu_torch.tools.profile_serving \
        --checkpoint docs/quality/denoiser_q5_swa.npz [--seconds 10]

serves a seeded utterance once to warm up (the contexts are then cached,
as in steady serving), then once under ``torch.profiler``, and prints the
tower's FLOPs per window (``FlopCounterMode``, conv + matmul), the rate
the call achieves, the summed kernel time against the wall time, the
device time by kind of kernel and the kernels with the most, beside the
card's name and power limit.  It asserts nothing; ``chip_smoke.py`` checks the outputs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from nhans_tpu_torch.cli._app import load_enhancer
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.tools.devtime import card, kernel_summary, print_kernels


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True, help="denoiser .npz")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    smi = card()
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
    s = kernel_summary(prof)
    print(f"one warm {args.seconds:g} s call: tower {per_window / 1e9:.3f} "
          f"GFLOP per window x {windows} windows in {wall:.3f} s = "
          f"{per_window * windows / wall / 1e12:.2f} TFLOP/s; summed kernel "
          f"time {s['busy_ms']:.1f} ms against {1e3 * wall:.1f} ms wall under "
          f"the profiler, {s['launches']:.0f} kernel launches, on {smi}")
    print_kernels(s, args.top)


if __name__ == "__main__":
    main()
