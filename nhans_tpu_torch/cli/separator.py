"""Speech source separation command line:
``python -m nhans_tpu_torch.cli.separator --help``."""

from nhans_tpu_torch.cli._app import run


def main() -> None:
    run("separator")


if __name__ == "__main__":
    main()
