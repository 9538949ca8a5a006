"""``load_denoiser`` / ``load_separator``: prepare a checkpoint for the
port, the port of ``nhans_tpu/cli/load_model.py``.

    python -m nhans_tpu_torch.cli.load_denoiser \\
        --tf_checkpoint trained_model/81448_0-1000000 --output denoiser_ckpt
    python -m nhans_tpu_torch.cli.load_separator --output separator_ckpt

With ``--tf_checkpoint`` it converts a published TF N-HANS checkpoint
(``compat/tf_import.py``); without it it writes the seeded random
initialisation of the serving CLIs, with a WARNING on stderr.  The output
is the Orbax variables directory the JAX command writes
(``train/checkpoint.py::save_variables``): every ``--checkpoint`` of
either package takes it, and ``train/checkpoint.py::load_into`` loads it
on any mesh.
"""

from __future__ import annotations

import argparse
import sys


def _run(task: str, argv=None) -> str:
    p = argparse.ArgumentParser(prog=f"python -m nhans_tpu_torch.cli."
                                     f"load_{task}")
    p.add_argument("--tf_checkpoint", default="",
                   help="path prefix of a TF N-HANS checkpoint "
                        "(e.g. .../81448_0-1000000) to convert")
    p.add_argument("--output", default=f"./{task}_ckpt",
                   help="directory to write the converted/initialized "
                        "variables directory into")
    args = p.parse_args(argv)

    from nhans_tpu_torch.compat.tf_import import import_tf_checkpoint
    from nhans_tpu_torch.compat.weights import flat_variables
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.models import random_init_state
    from nhans_tpu_torch.train.checkpoint import save_variables

    cfg = Config.denoiser() if task == "denoiser" else Config.separator()
    if args.tf_checkpoint:
        try:
            variables = import_tf_checkpoint(args.tf_checkpoint, cfg, task)
        except (OSError, ValueError) as err:
            sys.exit(f"error: {err}")
        print(f"converted TF checkpoint {args.tf_checkpoint}")
    else:
        print("WARNING: no --tf_checkpoint given; writing a fresh random "
              "initialization.", file=sys.stderr)
        variables = flat_variables(random_init_state(cfg))
    save_variables(args.output, variables)
    print(f"wrote checkpoint to {args.output}")
    return args.output


def main_denoiser(argv=None) -> str:
    return _run("denoiser", argv)


def main_separator(argv=None) -> str:
    return _run("separator", argv)


def console_denoiser() -> None:
    """The ``nhans_torch_load_denoiser`` console script: ``main_denoiser``,
    returning None (exit status 0) in place of the output path."""
    main_denoiser()


def console_separator() -> None:
    """The ``nhans_torch_load_separator`` console script."""
    main_separator()


if __name__ == "__main__":
    console_denoiser()
