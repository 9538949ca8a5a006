"""Deterministic evaluation of a checkpoint, the port of
``nhans_tpu/cli/evaluate.py``:

    python -m nhans_tpu_torch.cli.evaluate --task denoiser \\
        --checkpoint ck/nhans/5000 --speech_wav_dir speech/ \\
        --noise_wav_dir noise/ --eval_seeds test

``--checkpoint`` is a step directory the port's trainer wrote (or its
``<checkpoint_dir>`` root: the latest step) or a flat ``.npz`` of
weights.  It prints the split, then the loss and the scores
(SI-SDR, STOI, ESTOI, PESQ) over the md5-deterministic pairing of the
split, and dumps the reconstructions where ``--wav_dump_folder`` and
``--dump_results`` point.  ``--device`` (default ``cuda``) chooses the
card or ``cpu``.  The JAX command scores a random initialisation when no
checkpoint is given; the port cannot reproduce flax's random draws, so
it exits with a message instead.
"""

from __future__ import annotations

import argparse
import sys

from nhans_tpu_torch.config import add_training_flags, config_from_args


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m nhans_tpu_torch.cli.evaluate")
    p.add_argument("--task", choices=("denoiser", "separator"),
                   default="denoiser")
    p.add_argument("--checkpoint", default="",
                   help="a step directory of the port's trainer, or a "
                        "flat .npz of weights")
    p.add_argument("--eval_utts", type=int, default=0,
                   help="limit utterances (0 = whole split)")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda; "
                        "'cpu' runs the plain PyTorch path)")
    add_training_flags(p)
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if not args.checkpoint:
        sys.exit("--checkpoint is required: a step directory of "
                 "nhans_tpu_torch.cli.train or a flat .npz of weights, "
                 f"e.g. docs/quality/{args.task}_q5_swa.npz (scoring a "
                 "random initialisation is not ported; see ROADMAP.md)")
    cfg = config_from_args(args, task=args.task)

    from nhans_tpu_torch.compat.weights import from_flax
    from nhans_tpu_torch.data.loader import EvalLoader
    from nhans_tpu_torch.models import build_model
    from nhans_tpu_torch.train import checkpoint as ckpt
    from nhans_tpu_torch.train.evaluate import Evaluator
    from nhans_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
        variables, _ = ckpt.load(args.checkpoint)
    except (RuntimeError, ValueError, FileNotFoundError) as err:
        sys.exit(f"error: {err}")
    evaluator = Evaluator(cfg, build_model(cfg).to(device))
    loader = EvalLoader(cfg, limit=args.eval_utts or None)
    print(cfg.data.eval_seeds)
    metrics = evaluator.run(
        from_flax(variables), loader, step=0,
        modelname=cfg.train.model_name,
        wav_dump_folder=cfg.train.wav_dump_folder or None,
        dump_results=cfg.train.dump_results or None,
        max_utts=args.eval_utts or None, return_metrics=True)
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics


if __name__ == "__main__":
    main()
