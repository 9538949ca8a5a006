"""Operations of what a training step's hand-written convolution kernels
compute, from the configuration's shapes.

A step of ``examples`` windows runs the main tower once on the windows
and the context tower twice, once on each of every window's two context
crops.  The kernels compute, for every k x k convolution of both towers:
the forward; the input gradient of the stride-1 ones whose input is not
the data (the strided ones' goes to cuDNN, and the first layer of each
tower needs none); the weight gradient; and the bias gradient of those
with a bias (each block's second).  Two operations per multiply-add of
the direct sum and one per addition of the bias gradient, at the native
frequency width, whatever algorithm or padded geometry a program runs.
The 1 x 1 shortcuts, the head and the dense layers are left out.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple


def train_convs(cfg: dict) -> Iterator[Tuple[int, int, int, int, bool,
                                              bool, bool]]:
    """Each k x k convolution of both towers: (runs a window, cin, cout,
    output positions, stride 1, bias, reads the data), the main tower's
    first."""
    T, F, cin = cfg["window_frames"], cfg["num_bins"], 1
    for k, s, c in cfg["main_blocks"]:
        T, F = math.ceil(T / s), math.ceil(F / s)
        yield 1, cin * k * k, c, T * F, s == 1, False, cin == 1
        yield 1, c * k * k, c, T * F, True, True, False
        cin = c
    T, F, cin = cfg["context_frames"], cfg["num_bins"], 1
    for (kh, kw), (sh, sw), c in cfg["context_blocks"]:
        T, F = math.ceil(T / sh), math.ceil(F / sw)
        yield 2, cin * kh * kw, c, T * F, (sh, sw) == (1, 1), False, cin == 1
        yield 2, c * kh * kw, c, T * F, True, True, False
        cin = c


def step_conv_flops(cfg: dict, examples: int) -> int:
    """The direct operations of the kernels' work in a step of
    ``examples`` windows: forward, input gradient at stride 1 off the
    data, weight and bias gradients."""
    total = 0
    for runs, taps, cout, positions, unit, bias, data in train_convs(cfg):
        direct = 2 * positions * cout * taps        # one direction
        directions = 2 + (unit and not data)        # forward, dw (, dx)
        total += runs * (directions * direct + (positions * cout if bias
                                                else 0))
    return examples * total
