"""Layers and the conditional ResNet, as torch.nn modules."""

from nhans_tpu_torch.nn.blocks import (
    trunc_normal,
    Dense,
    Conv,
    BatchNorm,
    reverse_gradient,
)
from nhans_tpu_torch.nn.model import (
    PositionalMLP,
    ContextBlock,
    ContextEncoder,
    CondResBlock,
    NHANSNet,
    freq_loss_weights,
    freq_weighted_mse,
)

__all__ = [
    "trunc_normal", "Dense", "Conv", "BatchNorm", "reverse_gradient",
    "PositionalMLP", "ContextBlock", "ContextEncoder", "CondResBlock",
    "NHANSNet", "freq_loss_weights", "freq_weighted_mse",
]
