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
writes a torch.profiler trace of steps 10 to 20 into DIR.

Several ranks, one process each (``parallel/``): under ``torchrun`` the
environment gives the world,

    torchrun --nproc_per_node 8 -m nhans_tpu_torch.cli.train ...

and elsewhere ``--multihost --coordinator HOST:PORT --num_processes N
--process_id I`` on every process.  ``--data_axis`` x ``--model_axis``
must be the world size (``--data_axis 0``: the world divided by
``--model_axis``); each rank trains on ``cuda:{LOCAL_RANK}``, with NCCL
between the cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from nhans_tpu_torch.config import add_training_flags, config_from_args
from nhans_tpu_torch.parallel.mesh import initialize_multihost, make_mesh


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m nhans_tpu_torch.cli.train")
    p.add_argument("--task", choices=("denoiser", "separator"),
                   default="denoiser")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; 'cpu' "
                        "runs the plain PyTorch path)")
    p.add_argument("--data_axis", type=int, default=0,
                   help="data-parallel ranks (0: the world divided by "
                        "--model_axis)")
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel ranks: the wide kernels' output "
                        "channels split over them")
    p.add_argument("--multihost", action="store_true", default=False,
                   help="join a torch.distributed world of "
                        "--num_processes processes at --coordinator "
                        "(torchrun's environment needs no flag)")
    p.add_argument("--coordinator", default="",
                   help="HOST:PORT of rank 0 (or a file:// or tcp:// URL)")
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


def _join_world(args) -> None:
    """``--multihost`` joins the world its flags name, ``torchrun``'s
    environment the world it describes; otherwise the run has one rank.
    A world that is already joined stays.  ``--device cpu`` joins over
    gloo (NCCL takes CUDA tensors only)."""
    backend = "gloo" if args.device == "cpu" else None
    if args.multihost:
        if not (args.coordinator and args.num_processes > 0
                and args.process_id >= 0):
            sys.exit("--multihost needs --coordinator HOST:PORT, "
                     "--num_processes N and --process_id I (under torchrun "
                     "leave the four flags out)")
        initialize_multihost(args.coordinator, args.num_processes,
                             args.process_id, backend)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        initialize_multihost(backend=backend)


def build_trainer(argv=None):
    """Parse ``argv`` and build the Trainer, or exit with a message."""
    args = parser().parse_args(argv)
    _join_world(args)
    try:
        mesh = make_mesh(args.data_axis or None, args.model_axis)
    except ValueError as err:
        sys.exit(f"error: --data_axis {args.data_axis} x --model_axis "
                 f"{args.model_axis}: {err}")
    cfg = config_from_args(args, task=args.task)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, async_eval=args.async_eval, data_axis=mesh.data,
        model_axis=mesh.model))

    if mesh.is_primary:
        print("----------------------------- FLAGS VALUES "
              "--------------------------------")
        for k in sorted(vars(args)):
            print(f"{k}: {getattr(args, k)}")
        print("----------------------- DATA LOADING, MODEL PREPARING "
              "-------------------------")
        print(f"model_name: {cfg.train.model_name}")
        if mesh.size > 1:
            print(f"mesh: data {mesh.data} x model {mesh.model} ranks")

    from nhans_tpu_torch.train.trainer import Trainer
    from nhans_tpu_torch.utils.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:  # no card for the default --device cuda
        sys.exit(f"error: {err}")
    try:
        return Trainer(cfg, eval_utts=args.eval_utts, device=device,
                       mesh=mesh)
    except (ValueError, FileNotFoundError) as err:
        sys.exit(f"error: {err}")


def main(argv=None):
    from nhans_tpu_torch.utils.watchdog import install_stack_dump_signal

    # `kill -USR1 <pid>` dumps all thread stacks of a live run
    install_stack_dump_signal()
    trainer = build_trainer(argv)
    if trainer.primary:
        print("--------------------------------- TRAINING! "
              "------------------------------------")
    trainer.train()
    return trainer


def console_main() -> None:
    """The ``nhans_torch_train`` console script: ``main`` with the
    process group torn down after it, returning None (exit status 0)."""
    main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    console_main()
