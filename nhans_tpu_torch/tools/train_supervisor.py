"""Supervised training: run ``nhans_tpu_torch.cli.train`` in restartable
chunks, the port of ``tools/train_supervisor.py``.

Each chunk is a process that trains from the latest checkpoint to
``--batches <stop>`` and saves there; a chunk that fails without a new
checkpoint is retried up to ``--max_retries`` times in a row, one that
fails after progress just goes on.  Resume is the trainer's own
auto-resume from ``<checkpoint_dir>/<name>``.

    python -m nhans_tpu_torch.tools.train_supervisor --target 40000 \\
        --chunk 5000 -- --task denoiser --checkpoint_dir ck ...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from nhans_tpu_torch.train.checkpoint import list_steps

TRAIN = [sys.executable, "-m", "nhans_tpu_torch.cli.train"]


def latest_step(ckpt_dir: str, name: str = "nhans") -> int:
    """The newest complete step under ``<ckpt_dir>/<name>``, 0 if none."""
    steps = list_steps(os.path.join(ckpt_dir, name))
    return steps[-1] if steps else 0


def supervise(target: int, chunk: int, rest, max_retries: int = 3,
              command=TRAIN) -> list:
    """Run ``command + rest + ["--batches", stop]`` until the latest
    checkpoint reaches ``target``; returns each run's (start, stop, rc).
    Exits with a chunk's code after ``max_retries`` consecutive failures
    without progress."""
    try:
        ckpt_dir = rest[rest.index("--checkpoint_dir") + 1]
    except (ValueError, IndexError):
        print("supervisor: --checkpoint_dir required in cli.train args",
              file=sys.stderr)
        sys.exit(2)
    runs, retries = [], 0
    while True:
        start = latest_step(ckpt_dir)
        if start >= target:
            print(f"supervisor: target {target} reached "
                  f"(latest checkpoint step {start})", flush=True)
            return runs
        stop = min(start + chunk, target)
        cmd = [*command, *rest, "--batches", str(stop)]
        print(f"supervisor: [{start} -> {stop}] {' '.join(cmd)}",
              flush=True)
        rc = subprocess.call(cmd)
        runs.append((start, stop, rc))
        if rc != 0 and latest_step(ckpt_dir) <= start:
            retries += 1
            print(f"supervisor: chunk failed rc={rc} with no progress "
                  f"(retry {retries}/{max_retries})", flush=True)
            if retries > max_retries:
                sys.exit(rc)
        else:
            retries = 0


def main(argv=None) -> list:
    p = argparse.ArgumentParser(prog="python -m nhans_tpu_torch.tools."
                                     "train_supervisor")
    p.add_argument("--target", type=int, required=True)
    p.add_argument("--chunk", type=int, default=5000,
                   help="steps per process incarnation (every incarnation "
                        "ends on a checkpoint)")
    p.add_argument("--max_retries", type=int, default=3,
                   help="consecutive no-progress crashes tolerated")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="-- then cli.train args (must include "
                        "--checkpoint_dir)")
    args = p.parse_args(argv)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    return supervise(args.target, args.chunk, rest, args.max_retries)


if __name__ == "__main__":
    main()
