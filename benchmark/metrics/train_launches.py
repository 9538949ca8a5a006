"""Kernels launched per training step, counted in the trace."""


def read(facts, trace):
    if trace is None or "traced_steps" not in facts:
        return None
    return trace.launches() / facts["traced_steps"]
