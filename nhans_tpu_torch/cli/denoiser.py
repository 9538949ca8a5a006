"""Denoising / selective noise suppression command line:
``python -m nhans_tpu_torch.cli.denoiser --help``."""

from nhans_tpu_torch.cli._app import run


def main() -> None:
    run("denoiser")


if __name__ == "__main__":
    main()
