"""Kernels launched per interactive call, counted in the trace."""


def read(facts, trace):
    if trace is None or "traced_calls" not in facts:
        return None
    return trace.launches() / facts["traced_calls"]
