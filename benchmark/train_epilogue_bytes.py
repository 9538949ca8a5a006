"""Bytes a training step's epilogues have to move, from the
configuration's shapes.

Each of both towers' k x k convolutions is followed in training by an
epilogue (conditioning in the main tower, the residual after each block's
second convolution, BatchNorm on the batch's moments and ReLU).  The least
it moves, per element of the convolution's output, in float32: the
forward reads the output and, after a block's second convolution, the
residual, and writes its result; the backward reads the result's gradient
and one saved activation and writes the input's gradient.  That is 4 x (5
+ r) bytes an element, r 1 where there is a residual.  A step of
``examples`` windows runs the main tower once on the windows and the
context tower twice, once on each of every window's two context crops
(``train_conv_flops.train_convs``), at the native frequency width; the
small tables and the moments are left out.
"""

from __future__ import annotations

from benchmark.train_conv_flops import train_convs

ITEMSIZE = 4                 # float32
TRANSFERS = 5                # y in, out, dout in, saved in, dy out


def step_epilogue_bytes(cfg: dict, examples: int) -> int:
    """The least bytes of the 24 epilogues' forward and backward in a step
    of ``examples`` windows."""
    total = 0
    for runs, _, cout, positions, _, bias, _ in train_convs(cfg):
        # a block's second convolution (the one with a bias) feeds the
        # epilogue that adds the residual
        total += runs * cout * positions * ITEMSIZE * (TRANSFERS + bias)
    return examples * total
