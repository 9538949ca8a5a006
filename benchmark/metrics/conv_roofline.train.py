"""The training step's hand-written convolution kernels' share of the
float32 peak: the direct operations of what they compute in a step
(``train_conv_flops.step_conv_flops``: both towers' k x k convolutions'
forward, the stride-1 ones' input gradient, the weight and bias
gradients) over the traced steps, at the card's float32 peak, over the
summed device time of the ``tower_conv`` and ``conv_wgrad`` kernels in
the trace.

The widths are those of ``CELL``'s configuration, which readers are not
handed, and the windows a step those of the run's step FLOPs
(``facts["step_flops"]``, ``flops.train_step_flops``); a run whose step
FLOPs are not a whole number of that configuration's windows reads None.
So does a program whose ``train.forward`` spans count no ``hand_convs``
(one without the kernels, or a step off float32) or that has no such
spans."""

from benchmark import epilogue_bytes
from benchmark.flops import train_step_flops
from benchmark.peaks import peak
from benchmark.program_spans import recorded
from benchmark.train_conv_flops import step_conv_flops

CELL = "separator.train_sgd"


def read(facts, trace):
    if trace is None or "traced_steps" not in facts or "step_flops" not in \
            facts:
        return None
    cfg = epilogue_bytes.cell_config(CELL)
    examples, rest = divmod(facts["step_flops"], train_step_flops(cfg, 1))
    found = recorded(trace, "train.forward")
    rate = peak(facts, "flops")
    if (rest or examples < 1 or found is None or rate is None
            or any(s.counts.get("hand_convs", 0) == 0 for s in found)):
        return None
    t = trace.kernel_s("tower_conv") + trace.kernel_s("conv_wgrad")
    if t <= 0:
        return None
    return (100.0 * facts["traced_steps"] * step_conv_flops(cfg, examples)
            / rate / t)
