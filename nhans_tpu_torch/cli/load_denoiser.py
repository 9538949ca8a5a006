"""Convert a TF N-HANS denoiser checkpoint, or write a fresh one:
``python -m nhans_tpu_torch.cli.load_denoiser --help``."""

from nhans_tpu_torch.cli.load_model import main_denoiser as main

if __name__ == "__main__":
    main()
