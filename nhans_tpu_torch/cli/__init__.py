"""Command lines: nhans_tpu_torch.cli.denoiser / .separator (serving),
.train and .seeds (training), .evaluate (scoring), and .load_denoiser /
.load_separator (converting a TF checkpoint or writing a fresh one)."""
