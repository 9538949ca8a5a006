"""The part of the traced training steps in which nothing ran on the card
while the host was enqueueing the update: the trace's idle gaps inside
``train.update`` spans, as a share of the traced window."""

from benchmark.program_spans import idle_inside_pct, recorded


def read(facts, trace):
    if trace is None or "traced_steps" not in facts:
        return None
    found = recorded(trace, "train.update")
    return None if found is None else idle_inside_pct(trace, found)
