"""Model registry: the two published N-HANS task configurations, which
share one architecture and differ in what the two contexts mean."""

from __future__ import annotations

import torch

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.nn.blocks import Conv, Dense, trunc_normal_
from nhans_tpu_torch.nn.model import NHANSNet
from nhans_tpu_torch.utils.device import resolve_device


def build_model(cfg: Config) -> NHANSNet:
    return NHANSNet(cfg.model)


def init_variables(cfg: Config, generator: torch.Generator,
                   device="cuda") -> NHANSNet:
    """A model with seeded initial weights, the JAX package's init
    (``nhans_tpu/models/__init__.py::init_variables``) in distribution:
    every kernel a TF truncated normal of its layer's ``w_std`` (zero for
    the Inject projections, the positional MLPs' last layer and
    ``last_dense``), biases ``b_init``, BatchNorm beta 0 and gamma 1,
    population mean 0 and variance 1.  The draws come from ``generator``
    in module order, then the model moves to ``device``: the card unless
    the caller asks for ``cpu``."""
    device = resolve_device(device)
    model = build_model(cfg)
    for module in model.modules():
        if isinstance(module, (Conv, Dense)):
            trunc_normal_(module.w, module.w_std, generator)
            if module.b is not None:
                with torch.no_grad():
                    module.b.fill_(module.b_init)
    return model.to(device)


def random_init_state(cfg: Config) -> dict:
    """The weights of the commands that run without a checkpoint (the
    serving CLIs, ``cli.evaluate``, ``load_denoiser``/``load_separator``
    without ``--tf_checkpoint``): the ``state_dict`` of
    ``init_variables`` from a CPU generator seeded with 0, where the JAX
    commands take ``PRNGKey(0)``.  The draws are not flax's, but
    ``last_dense`` is zero with a zero bias, so the residual of this init
    is 0 whatever was drawn, and its served output and evaluation equal
    the JAX commands'."""
    return init_variables(cfg, torch.Generator().manual_seed(0),
                          "cpu").state_dict()


MODELS = {
    "denoiser": Config.denoiser,
    "separator": Config.separator,
}
