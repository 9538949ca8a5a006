"""Layers and the conditional ResNet, as torch.nn modules."""
