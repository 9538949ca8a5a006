"""The spectrogram kernel's share of its roofline while serving: the least
time the served mixtures' real samples in and their frames' outputs out
take at the card's memory bandwidth, over the summed device time of the
``log_spectrogram`` kernels in the trace."""

from benchmark.peaks import peak


def read(facts, trace):
    if trace is None or "traced_batches" not in facts:
        return None
    t = trace.kernel_s("log_spectrogram")
    bw = peak(facts, "bytes")
    if t <= 0 or bw is None:
        return None
    return 100.0 * facts["traced_spec_bytes"] / bw / t
