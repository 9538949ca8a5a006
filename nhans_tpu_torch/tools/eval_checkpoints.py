"""Score many checkpoints of one run in one process, the port of
``tools/eval_checkpoints.py``: one evaluator (and one model on the
device) for every step, one JSON line per step on standard output and,
with ``--jsonl``, appended to a file.

    python -m nhans_tpu_torch.tools.eval_checkpoints --task separator \\
        --checkpoint_root ck/nhans --steps 10000,20000,40000 \\
        --speech_wav_dir corpus/speech --noise_wav_dir corpus/noise \\
        --eval_seeds valid_seen --jsonl seen.jsonl

``--checkpoint_root`` is the directory of the port's step directories
(``<checkpoint_dir>/<model_name>``); without ``--steps`` every saved step
is scored.  ``--device`` (default ``cuda``) chooses the card or ``cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nhans_tpu_torch.tools.eval_checkpoints")
    p.add_argument("--task", choices=("denoiser", "separator"),
                   default="separator")
    p.add_argument("--checkpoint_root", required=True,
                   help="the run's directory of <step>/ subdirectories")
    p.add_argument("--steps", default="",
                   help="comma-separated steps (default: all saved)")
    p.add_argument("--speech_wav_dir", required=True)
    p.add_argument("--noise_wav_dir", required=True)
    p.add_argument("--eval_seeds", default="valid_seen")
    p.add_argument("--eval_utts", type=int, default=0)
    p.add_argument("--eval_pairing", default="wrap",
                   choices=("wrap", "queue"),
                   help="eval noise/speech pairing: wrap (every utterance "
                        "scored) or queue (the reference's one-epoch "
                        "queue order)")
    p.add_argument("--jsonl", default="", help="append records here")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def main(argv=None) -> list:
    args = parser().parse_args(argv)

    from nhans_tpu_torch.compat.weights import from_flax
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.data.loader import EvalLoader
    from nhans_tpu_torch.models import build_model
    from nhans_tpu_torch.train import checkpoint as ckpt
    from nhans_tpu_torch.train.evaluate import Evaluator
    from nhans_tpu_torch.utils.device import resolve_device

    cfg = (Config.denoiser() if args.task == "denoiser"
           else Config.separator())
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, speech_wav_dir=args.speech_wav_dir,
        noise_wav_dir=args.noise_wav_dir, eval_seeds=args.eval_seeds,
        eval_pairing=args.eval_pairing))
    steps = ([int(s) for s in args.steps.split(",")] if args.steps
             else sorted(int(d) for d in os.listdir(args.checkpoint_root)
                         if d.isdigit()))
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        sys.exit(f"error: {err}")
    evaluator = Evaluator(cfg, build_model(cfg).to(device))
    records = []
    out = open(args.jsonl, "a") if args.jsonl else None
    try:
        for step in steps:
            variables, _ = ckpt.load(os.path.join(args.checkpoint_root,
                                                  str(step)))
            loader = EvalLoader(cfg, limit=args.eval_utts or None)
            metrics = evaluator.run(
                from_flax(variables), loader, step=step, modelname="sweep",
                max_utts=args.eval_utts or None, return_metrics=True)
            rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return records


if __name__ == "__main__":
    main()
