"""Average the inference variables of several checkpoints of one run
(tail/SWA averaging) into a new Orbax variables directory, as the JAX
package writes it: the port of ``tools/ckpt_average.py``.

    python -m nhans_tpu_torch.tools.ckpt_average \\
        --checkpoint_root ck/nhans --steps 70000,72500,75000 --out ck_avg
    # then: python -m nhans_tpu_torch.cli.denoiser --checkpoint ck_avg ...

Every leaf is a uniform mean, the BatchNorm population statistics too
(the tail checkpoints' statistics are near-stationary, so no
re-estimation pass is needed).  Float leaves are averaged in float64 and
written float32; integer leaves pass through from the first checkpoint.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nhans_tpu_torch.train.checkpoint import load_variables, save_variables


def average_variables(flats):
    """The elementwise mean of a list of flat variable dicts."""
    out = {}
    for key, first in flats[0].items():
        if not np.issubdtype(first.dtype, np.floating):
            out[key] = first
            continue
        acc = np.zeros(first.shape, np.float64)
        for flat in flats:
            acc += np.asarray(flat[key], np.float64)
        out[key] = (acc / len(flats)).astype(np.float32)
    return out


def main(argv=None) -> str:
    p = argparse.ArgumentParser(prog="python -m nhans_tpu_torch.tools."
                                     "ckpt_average")
    p.add_argument("--checkpoint_root", required=True,
                   help="run directory holding <step>/ subdirectories "
                        "(e.g. <checkpoint_dir>/nhans)")
    p.add_argument("--steps", required=True,
                   help="comma-separated steps to average")
    p.add_argument("--out", required=True,
                   help="output variables directory, accepted by every "
                        "--checkpoint flag")
    args = p.parse_args(argv)

    steps = [int(s) for s in args.steps.split(",")]
    flats = []
    for s in steps:
        flats.append(load_variables(os.path.join(args.checkpoint_root,
                                                  str(s))))
        print(f"loaded step {s}")
    if any(set(f) != set(flats[0]) for f in flats):
        raise SystemExit("error: the checkpoints hold different variables")
    save_variables(args.out, average_variables(flats))
    print(f"averaged {len(steps)} checkpoints {steps} -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
