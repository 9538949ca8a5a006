"""Bytes the main tower's epilogues have to move, from the configuration's
shapes.

Each of the eight blocks follows its first convolution with an epilogue
that reads the convolution's output once and writes the block's next
input once, and its second with one that also reads the residual: five
transfers of the block's activation per window.  Counted at the native
frequency width, in the run's compute dtype; the small tables
(conditioning, position and BatchNorm vectors) are left out.
"""

from __future__ import annotations

import math
import os

from benchmark import harness

ITEMSIZE = {"float32": 4, "bfloat16": 2}
TRANSFERS = 5


def activation_elements(cfg: dict) -> int:
    """One window's elements of every block's output, summed over the
    blocks: channels x time x frequency after each block's stride."""
    T, F, total = cfg["window_frames"], cfg["num_bins"], 0
    for _, s, c in cfg["main_blocks"]:
        T, F = math.ceil(T / s), math.ceil(F / s)
        total += c * T * F
    return total


def window_bytes(cfg: dict, dtype: str) -> int:
    """The epilogues' bytes for one window computed in ``dtype``."""
    return TRANSFERS * activation_elements(cfg) * ITEMSIZE[dtype]


def cell_config(cell: str) -> dict:
    """The configuration file of the cell ``cell`` of BENCHMARK.json."""
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    files = {c["name"]: c["file"] for c in bench["configs"]}
    return harness.load_json(os.path.join(harness.ROOT,
                                          files[entry["config"]]))
