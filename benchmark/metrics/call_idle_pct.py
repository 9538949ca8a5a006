"""Share of the traced block of interactive calls in which nothing ran on
the card, both sides as the trace reads them: under the profiler the
host's launches and the many short kernels both take longer, so the
share is of the traced stretch, not of an untraced call."""


def read(facts, trace):
    if trace is None or "traced_calls" not in facts:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
