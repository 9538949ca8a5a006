"""Wav IO and device selection."""

from nhans_tpu_torch.utils import wavio  # noqa: F401
