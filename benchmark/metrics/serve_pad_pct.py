"""Share of the windows the serving engine computed over the traced
batches that carried no real audio (bucket and power-of-two padding):
100 x (1 - the real rows' frames, counted as ``real_windows`` on each
batch's ``enhance.dispatch`` span, over the rows x frames computed,
counted as ``windows`` on its ``enhance.run`` spans), over the batches
that have both spans in the traced window.

Which batches of the folder's cycle the trace holds depends on where the
window closes, and the cycle's batches pad differently, so the value is
comparable between runs only on the same batches.  The reader writes them
to stderr beside the value: each batch's id, real windows and windows
computed (rows x its bucket's frames)."""

import sys

from benchmark.program_spans import recorded


def read(facts, trace):
    if trace is None or "traced_batches" not in facts:
        return None
    found = recorded(trace, "enhance.dispatch", "enhance.run")
    if found is None:
        return None
    real, computed = {}, {}
    for s in found:
        if s.name == "enhance.dispatch":
            real[s.id] = real.get(s.id, 0) + s.counts.get("real_windows", 0)
        else:
            computed[s.id] = computed.get(s.id, 0) + s.counts.get("windows", 0)
    both = sorted(set(real) & set(computed))
    total = sum(computed[i] for i in both)
    if total == 0:
        return None
    print("serve_pad_pct: traced batches (id, real windows, windows): "
          + ", ".join(f"({i}, {real[i]}, {computed[i]})" for i in both),
          file=sys.stderr)
    return 100.0 * (1.0 - sum(real[i] for i in both) / total)
