"""The training epilogue kernels' share of their roofline
(benchmark/metrics/epilogue_roofline.train.py) and its yardstick
(benchmark/train_epilogue_bytes.py): the yardstick counts, by hand at the
separator's widths, 222 M main-tower and 304 M context-tower output
elements for 64 windows and 4 x (5 + r) bytes each, and equals the
elements of the epilogues the port's routing sends to the kernels; the
reader gives the exact share on a stub trace and synthetic spans, and
None without the kernels, without spans counting ``hand_epilogues``, or
for a run whose step FLOPs are not the configuration's."""

import types

import pytest
import torch
import torch.nn.functional as F

from benchmark import epilogue_bytes, harness
from benchmark.flops import train_step_flops
from benchmark.train_conv_flops import train_convs
from benchmark.train_epilogue_bytes import step_epilogue_bytes
from nhans_tpu_torch.utils import spans

MS = 1_000_000
CFG = epilogue_bytes.cell_config("separator.train_sgd")


def _facts(examples=64, **extra):
    return dict({"traced_steps": 3, "device_kind": "NVIDIA H100 80GB HBM3",
                 "dtype": "float32",
                 "step_flops": train_step_flops(CFG, examples)}, **extra)


class KernelTrace:
    """A stub trace whose ``train_epilogue`` kernels took ``s`` seconds."""

    def __init__(self, s):
        self.start_ns, self.end_ns = 0, 10 * MS
        self.s = s

    def kernel_s(self, fragment):
        return self.s if fragment == "train_epilogue" else 0.0


@pytest.fixture
def recorded(monkeypatch):
    planted = []
    monkeypatch.setattr(spans, "between", lambda t0, t1: [
        s for s in planted if s.start_ns >= t0 and s.end_ns <= t1])
    return planted


def _forward(step, hand_epilogues, t0_ms=1):
    return types.SimpleNamespace(
        name="train.forward", id=step, start_ns=int(t0_ms * MS),
        end_ns=int((t0_ms + 1) * MS),
        counts={"hand_convs": 24, "hand_epilogues": hand_epilogues},
        device_ms=None, parent=None)


def step_epilogue_elements(cfg, examples):
    """(main tower, context tower) output elements of the epilogues in a
    step of ``examples`` windows, from the convolutions they follow (the
    context tower's run twice)."""
    towers = [0, 0]
    for runs, _, cout, positions, _, _, _ in train_convs(cfg):
        towers[runs > 1] += runs * cout * positions
    return examples * towers[0], examples * towers[1]


def read(facts, trace):
    return harness.load_module("metrics", "epilogue_roofline.train").read(
        facts, trace)


def test_counts_the_separators_elements_by_hand():
    """The main tower's 16 outputs: 64 channels at 35 x 201 (4), 128 at 18
    x 101 (4), 256 at 9 x 51 (4), 512 at 5 x 26 (4); the context tower's 8
    on both crops: 64 at 67 x 101 (2), 128 and 256 at 23 x 51 (2 each),
    512 at 23 x 26 (2).  Half of each tower's epilogues add a residual."""
    main = 4 * (64 * 35 * 201 + 128 * 18 * 101 + 256 * 9 * 51
                + 512 * 5 * 26)
    ctx = 2 * 2 * (64 * 67 * 101 + 128 * 23 * 51 + 256 * 23 * 51
                   + 512 * 23 * 26)
    assert main == 3_468_032 and ctx == 4_758_784
    got = step_epilogue_elements(CFG, 64)
    assert got == (64 * main, 64 * ctx)
    assert 221e6 < got[0] < 223e6 and 304e6 < got[1] < 305e6
    assert step_epilogue_bytes(CFG, 64) == 64 * 4 * (
        5 * (main + ctx) + (main + ctx) // 2)
    assert step_epilogue_bytes(CFG, 1) * 64 == step_epilogue_bytes(CFG, 64)


def test_yardstick_is_the_routed_epilogues(monkeypatch):
    """On the meta device, with the routing let through there: the
    epilogues handed to TrainEpilogue in a training forward of one window
    (its two context crops through the context tower) are 32 calls of 24
    BatchNorms, whose outputs and residuals come to the yardstick."""
    from benchmark.serving import port_config
    from nhans_tpu_torch.nn import model as nn_model
    from nhans_tpu_torch.nn.model import NHANSNet
    from nhans_tpu_torch.ops import tower_conv as tc
    from nhans_tpu_torch.ops import train_epilogue as te

    calls = []

    def counting(y, residual, a, b, t, f, gamma, beta, bn, valid):
        calls.append((y.numel(), residual is not None, a is not None))
        return torch.relu(y)

    monkeypatch.setattr(nn_model, "KERNEL_DEVICES", ("meta",))
    monkeypatch.setattr(te.TrainEpilogue, "apply", counting)
    monkeypatch.setattr(tc.TrainConv, "apply", lambda x, w, b, s, p: F.conv2d(
        F.pad(x, p), w, b, stride=s))
    with torch.device("meta"), nn_model.hand_epilogues() as seen:
        model = NHANSNet(port_config(CFG).model).train()
        model(torch.zeros(1, 35, 201), torch.zeros(1, 200, 201),
              torch.zeros(1, 200, 201))
    assert len(calls) == 16 + 2 * 8 and len(seen) == 24
    assert sum(a for _, _, a in calls) == 16
    assert sum(r for _, r, _ in calls) == 8 + 2 * 4
    assert step_epilogue_bytes(CFG, 1) == sum(4 * (5 + r) * n
                                              for n, r, _ in calls)
    assert sum(step_epilogue_elements(CFG, 1)) == sum(n for n, _, _ in calls)


def test_reads_the_traced_steps_kernel_share(recorded):
    recorded += [_forward(s, 24, 1 + 2 * s) for s in range(3)]
    trace = KernelTrace(0.03)
    got = read(_facts(), trace)
    assert got == pytest.approx(
        100 * 3 * step_epilogue_bytes(CFG, 64) / 3.35e12 / 0.03, rel=1e-12)
    assert 0 < got < 100
    # 16 windows a step: the yardstick follows the run's step FLOPs
    assert read(_facts(16), trace) == pytest.approx(got / 4, rel=1e-12)


def test_reads_none_where_the_kernels_did_not_run(recorded):
    recorded += [_forward(s, 24, 1 + 2 * s) for s in range(3)]
    trace = KernelTrace(0.03)
    assert read(_facts(), None) is None
    assert read({}, trace) is None
    # another configuration's step FLOPs
    assert read(_facts(step_flops=train_step_flops(CFG, 64) + 1),
                trace) is None
    assert read(_facts(device_kind="cpu"), trace) is None
    assert read(_facts(), KernelTrace(0.0)) is None
    # the parent: spans without the count, or with it at 0
    recorded[:] = [_forward(s, 0, 1 + 2 * s) for s in range(3)]
    assert read(_facts(), trace) is None
    for s in recorded:
        del s.counts["hand_epilogues"]
    assert read(_facts(), trace) is None
    # no spans at all
    recorded.clear()
    assert read(_facts(), trace) is None
