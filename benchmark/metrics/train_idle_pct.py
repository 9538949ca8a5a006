"""Share of a training step in which nothing ran on the card: the traced
steps' device time against as many steps of the untraced window's mean
step time (the profiler slows the host's launches)."""


def read(facts, trace):
    if trace is None or "traced_steps" not in facts:
        return None
    return 100.0 * (1.0 - trace.busy_s()
                    / (facts["traced_steps"] * facts["step_s"]))
