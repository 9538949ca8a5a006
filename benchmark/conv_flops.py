"""Operations of the main tower's k x k convolutions, from the
configuration's shapes.

Each of the blocks runs two of them: ``conv1`` (the block's stride, from
its input channels) and ``conv2`` (stride 1).  Two floating-point
operations per multiply-add of the direct sum, at the native frequency
width, whatever algorithm or padded geometry a program runs; the 1 x 1
shortcuts, the conditioning and the head are left out (``flops.py``
counts them in ``window_flops``).
"""

from __future__ import annotations

import math


def window_conv_flops(cfg: dict) -> int:
    """The direct operations of the tower's k x k convolutions for one
    window."""
    T, F, cin, total = cfg["window_frames"], cfg["num_bins"], 1, 0
    for k, s, c in cfg["main_blocks"]:
        T, F = math.ceil(T / s), math.ceil(F / s)
        total += 2 * T * F * c * (cin + c) * k * k    # conv1 and conv2
        cin = c
    return total
