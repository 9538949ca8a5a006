"""Serving command lines: nhans_tpu_torch.cli.denoiser / .separator."""
