"""The part of the traced interactive block in which nothing ran on the
card while the host was enqueueing a call's device work: the trace's idle
gaps inside ``enhance.launch`` spans, as a share of the traced window;
one part of ``call_idle_pct``."""

from benchmark.program_spans import idle_inside_pct, recorded


def read(facts, trace):
    if trace is None or "traced_calls" not in facts:
        return None
    found = recorded(trace, "enhance.launch")
    return None if found is None else idle_inside_pct(trace, found)
