"""Training command line with the reference's flags, the port of
``nhans_tpu/cli/train.py``:

    python -m nhans_tpu_torch.cli.train --task denoiser \\
        --speech_wav_dir speech/ --noise_wav_dir noise/ \\
        --batches 1000 --alg adam --lr 1e-4 --checkpoint_dir ck/

``--device`` (default ``cuda``) chooses the card or ``cpu``.  Each
checkpoint (every ``--eval_every`` steps and at the end) is scored on
``--eval_utts`` utterances of the ``--eval_seeds`` split, synchronously
or, with ``--async_eval``, on a thread while training goes on;
``--eval_utts 0`` writes an all-zero record and reads no eval manifest.
``--dtype bfloat16`` computes the model in bfloat16 (parameters,
optimizer state, BatchNorm statistics, spectrograms and the loss stay
float32, and checkpoints are float32), ``--remat`` recomputes each
main-tower block in the backward pass, ``--freq_pad_to 256`` carries the
main tower's frequency axis on 256 columns, and ``--profile_dir DIR``
writes a torch.profiler trace of steps 10 to 20 into DIR.  The JAX
package's multi-device options (``--data_axis``/``--model_axis`` above 1,
``--multihost``) are accepted by the parser and refused with a message:
they are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from nhans_tpu_torch.config import add_training_flags, config_from_args


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m nhans_tpu_torch.cli.train")
    p.add_argument("--task", choices=("denoiser", "separator"),
                   default="denoiser")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' "
                        "runs the plain PyTorch path)")
    p.add_argument("--data_axis", type=int, default=0,
                   help="data-parallel size (0 or 1: one card; more is "
                        "not ported)")
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel size (1; more is not ported)")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="not ported")
    p.add_argument("--coordinator", default="")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--eval_utts", type=int, default=16,
                   help="utterances per evaluation pass (0: save "
                        "without scoring, an all-zero record)")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of steps 10-20 here")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="model compute dtype (bfloat16 for the tensor "
                        "cores; float32 for strict parity)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute main-tower blocks in the backward pass "
                        "(activation memory for FLOPs)")
    p.add_argument("--async_eval", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="score the periodic checkpoints on a thread (and "
                        "a CUDA stream of its own) while training goes "
                        "on")
    add_training_flags(p)
    return p


def _refusal(args) -> str:
    """The message for a flag the port does not have, or ''."""
    refused = [
        (args.data_axis > 1, f"--data_axis {args.data_axis}"),
        (args.model_axis > 1, f"--model_axis {args.model_axis}"),
        (args.multihost, "--multihost"),
    ]
    names = [name for hit, name in refused if hit]
    if not names:
        return ""
    return (f"{', '.join(names)}: not ported to nhans_tpu_torch yet (see "
            "ROADMAP.md, Queue 1); the port trains on one device")


def build_trainer(argv=None):
    """Parse ``argv`` and build the Trainer, or exit with a message."""
    args = parser().parse_args(argv)
    msg = _refusal(args)
    if msg:
        sys.exit(msg)
    cfg = config_from_args(args, task=args.task)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                async_eval=args.async_eval))

    print("----------------------------- FLAGS VALUES "
          "--------------------------------")
    for k in sorted(vars(args)):
        print(f"{k}: {getattr(args, k)}")
    print("----------------------- DATA LOADING, MODEL PREPARING "
          "-------------------------")
    print(f"model_name: {cfg.train.model_name}")

    from nhans_tpu_torch.train.trainer import Trainer
    from nhans_tpu_torch.utils.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card for the default --device cuda
        sys.exit(f"error: {err}")
    try:
        return Trainer(cfg, eval_utts=args.eval_utts, device=device)
    except (ValueError, FileNotFoundError) as err:
        sys.exit(f"error: {err}")


def main(argv=None):
    from nhans_tpu_torch.utils.watchdog import install_stack_dump_signal

    # `kill -USR1 <pid>` dumps all thread stacks of a live run
    install_stack_dump_signal()
    trainer = build_trainer(argv)
    print("--------------------------------- TRAINING! "
          "------------------------------------")
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
