"""The main tower's epilogue kernel's share of its roofline while serving
the folder: the least time its bytes take at the card's memory bandwidth
(``epilogue_bytes.window_bytes`` for each window computed, the ``windows``
counts of the traced batches' ``enhance.run`` spans), over the summed
device time of the ``tower_epilogue`` kernels in the trace.  A program
without that kernel or those spans reads None.

The widths are those of ``CELL``'s configuration, which readers are not
handed; a run whose window FLOPs (``facts["window_flops"]``) are not that
configuration's is of another tower and reads None.  The item size is the
run's own ``facts["dtype"]``."""

from benchmark import epilogue_bytes
from benchmark.flops import window_flops
from benchmark.peaks import peak
from benchmark.program_spans import recorded

CELL = "denoiser.folder"


def read(facts, trace):
    if trace is None or "traced_batches" not in facts:
        return None
    cfg = epilogue_bytes.cell_config(CELL)
    if (facts.get("window_flops") != window_flops(cfg)
            or facts.get("dtype") not in epilogue_bytes.ITEMSIZE):
        return None
    t = trace.kernel_s("tower_epilogue")
    bw = peak(facts, "bytes")
    found = recorded(trace, "enhance.run")
    if t <= 0 or bw is None or found is None:
        return None
    windows = sum(s.counts.get("windows", 0) for s in found)
    return (100.0 * windows * epilogue_bytes.window_bytes(cfg, facts["dtype"])
            / bw / t)
