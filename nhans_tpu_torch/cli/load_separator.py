"""Convert a TF N-HANS separator checkpoint, or write a fresh one:
``python -m nhans_tpu_torch.cli.load_separator --help``."""

from nhans_tpu_torch.cli.load_model import main_separator as main

if __name__ == "__main__":
    main()
