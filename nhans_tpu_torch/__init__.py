"""N-HANS in PyTorch for NVIDIA Hopper: the port of ``nhans_tpu``.

The layout mirrors ``nhans_tpu`` module for module.  The port imports
torch, numpy and scipy, and nothing of JAX or of ``nhans_tpu``.  Its entry
points run on ``cuda`` unless the caller asks for ``cpu``; the one TPU
kernel of the JAX package, the fused spectrogram, is a hand-written CUDA
kernel here (``ops/stft_cuda.py``, ``csrc/log_spectrogram.cu``).
"""

from nhans_tpu_torch.version import __version__

__all__ = ["__version__"]
