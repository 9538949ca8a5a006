"""Share of the traced stretch of folder serving in which nothing ran on
the card: the trace's own window, whose host work the profiler barely
slows here (the card runs behind the host)."""


def read(facts, trace):
    if trace is None or "traced_batches" not in facts:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
