"""Device time of a training step's update (the gradients, their global
norm, the optimizer and the in-place add): the mean over the traced
steps of the ``train.update`` spans' CUDA-event time."""

from benchmark.program_spans import recorded


def read(facts, trace):
    if trace is None or "traced_steps" not in facts:
        return None
    found = recorded(trace, "train.update")
    times = [s.device_ms for s in found or () if s.device_ms is not None]
    return sum(times) / len(times) if times else None
