"""Frame-axis windowing: padding, sliding windows, rest-crop indexing, the
port of ``nhans_tpu/dsp/windowing.py`` on tensors.

A window of ``length`` frames is centred on each frame of a spectrogram
padded with ``pad_amounts(length)`` zero frames; the windows are gathers
into that padded axis.  The serving engine, the evaluation windows and
the training crops all pad through ``pad_for_windowing``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_amounts(length: int) -> Tuple[int, int]:
    """(before, after) padding for a sliding window of ``length`` centred
    on each frame: ((length+1)//2 - 1, length//2)."""
    return ((length + 1) // 2) - 1, length // 2


def pad_for_windowing(x: torch.Tensor, length: int,
                      axis: int = -2) -> torch.Tensor:
    """Zero-pad the frame axis so every original frame can be a window
    centre."""
    before, after = pad_amounts(length)
    axis = axis if axis >= 0 else x.ndim + axis
    pads = [0, 0] * (x.ndim - axis - 1) + [before, after]
    return F.pad(x, pads)


def window_gather_indices(num_windows: int, length: int, stride: int = 1,
                          device=None) -> torch.Tensor:
    """Gather index matrix [num_windows, length] into a padded
    spectrogram's frame axis."""
    return (torch.arange(num_windows, device=device)[:, None] * stride
            + torch.arange(length, device=device)[None, :])


def strided_windows(x: torch.Tensor, length: int,
                    stride: int = 1) -> torch.Tensor:
    """All sliding windows of a [T, F] spectrogram -> [N, length, F], with
    N = ceil(T / stride): one window per original frame at stride 1."""
    padded = pad_for_windowing(x, length, axis=0)
    n = (padded.shape[0] - length) // stride + 1
    return padded[window_gather_indices(n, length, stride, x.device)]


def rest_crop_indices(start, context_len: int, winstart,
                      winlength: int) -> torch.Tensor:
    """Indices of ``context_len`` consecutive frames of the "rest": the
    spectrogram with frames [winstart, winstart + winlength) removed.

    Equal to ``cat(x[:winstart], x[winstart+winlength:])[start:start +
    context_len]`` without building the concatenation: indices from
    ``winstart`` on skip the excised window.  ``start`` and ``winstart``
    are ints or integer tensors that broadcast against the last axis of
    the result (e.g. [..., 1])."""
    device = next((v.device for v in (start, winstart)
                   if torch.is_tensor(v)), None)
    idx = torch.as_tensor(start, device=device) + torch.arange(
        context_len, device=device)
    return idx + torch.where(idx >= torch.as_tensor(winstart, device=device),
                             winlength, 0)
