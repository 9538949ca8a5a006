"""Where one warm full-width training step spends its time on the card.

    python -m nhans_tpu_torch.tools.profile_training [--alg sgd adam]
        [--dtype float32 bfloat16] [--steps 8]

builds the denoiser at full width with its seeded init, banks a seeded
synthetic corpus on the card (8 utterances of 10.2 s, 6 noises), and for
each compute dtype and optimizer named takes three banked steps of 16 utterances x 4 crops
to warm up, ``--steps`` back to back timed by the host's clock from one
synchronisation to the next, then two under ``torch.profiler``.  It
prints per step: the time of the back-to-back steps and how long the
host took to enqueue one; the summed kernel time under the profiler, so
the share of the unprofiled step the card was busy; the wall time and
kernel launches under the profiler; the device time by kind of kernel,
and the kernels with the most device time, beside the card's name and
power limit.  It asserts nothing; ``chip_smoke.py`` checks the training
path.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.models import init_variables
from nhans_tpu_torch.tools.devtime import card, kernel_summary, print_kernels
from nhans_tpu_torch.train.step import (make_train_step, make_tx, state_of,
                                        step_generator)
from nhans_tpu_torch.utils.device import to_device


def _banks(cfg: Config, rng, device):
    """Seeded int16 banks: 8 utterances and 6 noises of whole frames."""
    L = cfg.data.max_samples
    t = np.arange(L) / cfg.audio.sample_rate
    speech = np.stack([7000 * np.sin(2 * np.pi * (120 + 25 * i) * t)
                       + rng.standard_normal(L) * 900 for i in range(8)])
    noise = rng.standard_normal((6, L)) * 2500
    banks = {}
    for name, x in (("speech", speech), ("noise", noise)):
        wav = np.clip(np.rint(x), -32768, 32767).astype(np.int16)
        banks[name] = torch.from_numpy(wav).to(device)
        banks[f"{name}_len"] = torch.full((len(x),), L, dtype=torch.int32,
                                          device=device)
        banks[f"{name}_peak"] = torch.from_numpy(
            np.abs(wav).max(1).astype(np.float32)).to(device)
    return banks


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--alg", nargs="+", default=["sgd", "adam"])
    p.add_argument("--dtype", nargs="+", default=["float32"],
                   choices=("float32", "bfloat16"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    smi = card()
    dev = torch.device("cuda")
    base = Config.denoiser()
    rng = np.random.default_rng(args.seed)
    banks = _banks(base, rng, dev)
    B = base.train.train_mb // base.data.slices_per_step
    for dtype, alg in ((d, a) for d in args.dtype for a in args.alg):
        cfg = base.replace(
            model=dataclasses.replace(base.model, compute_dtype=dtype),
            train=dataclasses.replace(base.train, alg=alg))
        g = torch.Generator()
        g.manual_seed(args.seed)
        model = init_variables(cfg, g, dev)
        tx = make_tx(cfg)
        state = state_of(model, tx)
        step = make_train_step(cfg, model, tx, banked=True)

        def one(i):
            r = np.random.default_rng((args.seed, i))
            # the index triples as the trainer's prefetch thread sends
            # them: pinned, without blocking
            idx = {k: to_device(torch.from_numpy(
                       r.integers(n, size=B).astype(np.int32)), dev)
                   for k, n in (("clean_idx", 8), ("a_idx", 6),
                                ("b_idx", 6))}
            return step(state, banks, idx, step_generator(args.seed, i))

        for i in range(3):
            one(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3, 3 + args.steps):
            one(i)
        enqueued = (time.perf_counter() - t0) / args.steps
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
        steps = 2
        first = 3 + args.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(first, first + steps):
                one(i)
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) / steps
        s = kernel_summary(prof, steps)
        busy = s["busy_ms"] / (1e3 * wall)
        print(f"{dtype} {alg}: one warm full-width step ({B} utterances x "
              f"{cfg.data.slices_per_step} crops): {1e3 * wall:.1f} ms over "
              f"{args.steps} back-to-back steps (the host enqueued a step in "
              f"{1e3 * enqueued:.1f} ms); summed kernel time "
              f"{s['busy_ms']:.1f} ms under the profiler, the card busy "
              f"{100 * busy:.1f} % and idle {100 * (1 - busy):.1f} % of the "
              f"unprofiled step; under the profiler {1e3 * wall_prof:.1f} ms"
              f" wall, {s['launches']:.0f} kernel launches; on {smi}")
        print_kernels(s, args.top)
        del model, state, step


if __name__ == "__main__":
    main()
