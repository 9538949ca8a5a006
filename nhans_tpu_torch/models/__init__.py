"""Model registry: the two published N-HANS task configurations, which
share one architecture and differ in what the two contexts mean."""

from __future__ import annotations

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.nn.model import NHANSNet


def build_model(cfg: Config) -> NHANSNet:
    return NHANSNet(cfg.model)


MODELS = {
    "denoiser": Config.denoiser,
    "separator": Config.separator,
}
