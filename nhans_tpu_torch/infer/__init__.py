"""Whole-utterance enhancement."""

from nhans_tpu_torch.infer.enhance import Enhancer  # noqa: F401
