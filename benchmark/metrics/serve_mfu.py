"""Share of the float32 peak that the window's real work reached: real
(unpadded) frames served x the yardstick's operations per window, over
the untraced window's time (``flops.window_flops``, ``peaks.json``)."""

from benchmark.peaks import peak


def read(facts, trace):
    if "real_windows" not in facts or "window_flops" not in facts:
        return None
    rate = facts["real_windows"] * facts["window_flops"] / facts["window_s"]
    p = peak(facts, "flops")
    return None if p is None else 100.0 * rate / p
