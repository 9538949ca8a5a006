"""Host time a traced interactive call spends enqueueing its device work:
the summed ``enhance.launch`` spans of the traced block over its calls."""

from benchmark.program_spans import recorded


def read(facts, trace):
    if trace is None or "traced_calls" not in facts:
        return None
    found = recorded(trace, "enhance.launch")
    if found is None:
        return None
    host_ns = sum(s.end_ns - s.start_ns for s in found)
    return host_ns / 1e6 / facts["traced_calls"]
