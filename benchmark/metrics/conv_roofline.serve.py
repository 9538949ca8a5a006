"""The main tower's convolution kernel's share of the float32 peak while
serving the folder: the direct operations of the tower's k x k
convolutions (``conv_flops.window_conv_flops`` for each window computed,
the ``windows`` counts of the traced batches' ``enhance.run`` spans) at
the card's float32 peak, over the summed device time of the
``tower_conv`` kernels in the trace.  A program without that kernel or
those spans reads None.

The widths are those of ``CELL``'s configuration, which readers are not
handed; a run whose window FLOPs (``facts["window_flops"]``) are not that
configuration's is of another tower and reads None, as does a run whose
``facts["dtype"]`` is not float32, where the kernel does not run."""

from benchmark import epilogue_bytes
from benchmark.conv_flops import window_conv_flops
from benchmark.flops import window_flops
from benchmark.peaks import peak
from benchmark.program_spans import recorded

CELL = "denoiser.folder"


def read(facts, trace):
    if trace is None or "traced_batches" not in facts:
        return None
    cfg = epilogue_bytes.cell_config(CELL)
    if (facts.get("window_flops") != window_flops(cfg)
            or facts.get("dtype") != "float32"):
        return None
    t = trace.kernel_s("tower_conv")
    rate = peak(facts, "flops")
    found = recorded(trace, "enhance.run")
    if t <= 0 or rate is None or found is None:
        return None
    windows = sum(s.counts.get("windows", 0) for s in found)
    return 100.0 * windows * window_conv_flops(cfg) / rate / t
