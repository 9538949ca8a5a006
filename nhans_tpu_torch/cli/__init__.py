"""Command lines: nhans_tpu_torch.cli.denoiser / .separator (serving),
.train and .seeds (training)."""
