"""The training step's hand-written epilogue kernels' share of their
roofline: the least bytes of both towers' 24 epilogues' forward and
backward in a step (``train_epilogue_bytes.step_epilogue_bytes``, 4 x (5 +
r) bytes an element of each k x k convolution's output) over the traced
steps, at the card's memory bandwidth, over the summed device time of the
``train_epilogue`` kernels in the trace.

The widths are those of ``CELL``'s configuration, which readers are not
handed, and the windows a step those of the run's step FLOPs
(``facts["step_flops"]``, ``flops.train_step_flops``); a run whose step
FLOPs are not a whole number of that configuration's windows reads None.
So does a program whose ``train.forward`` spans count no
``hand_epilogues`` (one without the kernels, or a step off float32) or
that has no such spans."""

from benchmark import epilogue_bytes
from benchmark.flops import train_step_flops
from benchmark.peaks import peak
from benchmark.program_spans import recorded
from benchmark.train_epilogue_bytes import step_epilogue_bytes

CELL = "separator.train_sgd"


def read(facts, trace):
    if trace is None or "traced_steps" not in facts or "step_flops" not in \
            facts:
        return None
    cfg = epilogue_bytes.cell_config(CELL)
    examples, rest = divmod(facts["step_flops"], train_step_flops(cfg, 1))
    found = recorded(trace, "train.forward")
    bw = peak(facts, "bytes")
    if (rest or examples < 1 or found is None or bw is None
            or any(s.counts.get("hand_epilogues", 0) == 0 for s in found)):
        return None
    t = trace.kernel_s("train_epilogue")
    if t <= 0:
        return None
    return (100.0 * facts["traced_steps"] * step_epilogue_bytes(cfg, examples)
            / bw / t)
