"""Share of the float32 peak that a training step reached: the
yardstick's forward and backward operations of a step over the untraced
window's mean step time (``flops.train_step_flops``, ``peaks.json``)."""

from benchmark.peaks import peak


def read(facts, trace):
    if "step_flops" not in facts or "step_s" not in facts:
        return None
    p = peak(facts, "flops")
    return None if p is None else (100.0 * facts["step_flops"]
                                   / facts["step_s"] / p)
