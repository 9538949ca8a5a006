"""The training convolution kernels' share of the float32 peak
(benchmark/metrics/conv_roofline.train.py) and its yardstick
(benchmark/train_conv_flops.py): the yardstick equals the operations of
the convolutions the port's routing sends to the kernels in a training
forward and backward, counted from the shapes it hands them; the reader
gives the exact share on a stub trace and synthetic spans, and None
without the kernels, without spans counting ``hand_convs``, or for a run
whose step FLOPs are not the configuration's."""

import types

import pytest
import torch
import torch.nn.functional as F

from benchmark import epilogue_bytes, harness
from benchmark.flops import train_step_flops
from benchmark.train_conv_flops import step_conv_flops, train_convs
from nhans_tpu_torch.utils import spans

MS = 1_000_000
CFG = epilogue_bytes.cell_config("separator.train_sgd")


def _facts(examples=64, **extra):
    return dict({"traced_steps": 3, "device_kind": "NVIDIA H100 80GB HBM3",
                 "dtype": "float32",
                 "step_flops": train_step_flops(CFG, examples)}, **extra)


class KernelTrace:
    """A stub trace whose ``tower_conv`` and ``conv_wgrad`` kernels took
    the given seconds."""

    def __init__(self, conv_s, wgrad_s):
        self.start_ns, self.end_ns = 0, 10 * MS
        self.s = {"tower_conv": conv_s, "conv_wgrad": wgrad_s}

    def kernel_s(self, fragment):
        return self.s.get(fragment, 0.0)


@pytest.fixture
def recorded(monkeypatch):
    planted = []
    monkeypatch.setattr(spans, "between", lambda t0, t1: [
        s for s in planted if s.start_ns >= t0 and s.end_ns <= t1])
    return planted


def _forward(step, hand_convs, t0_ms=1):
    return types.SimpleNamespace(name="train.forward", id=step,
                                 start_ns=int(t0_ms * MS),
                                 end_ns=int((t0_ms + 1) * MS),
                                 counts={"hand_convs": hand_convs},
                                 device_ms=None, parent=None)


def read(facts, trace):
    return harness.load_module("metrics", "conv_roofline.train").read(
        facts, trace)


def test_yardstick_is_the_routed_convolutions_work(monkeypatch):
    """On the meta device, with the routing let through there: the
    convolutions handed to TrainConv in a training forward of one window
    (its two context crops through the context tower) are the 24 k x k
    ones, and their forward, the input gradient of those at stride 1 whose
    input needs one, and the weight and bias gradients come to
    step_conv_flops(cfg, 1)."""
    from benchmark.serving import port_config
    from nhans_tpu_torch.nn import model as nn_model
    from nhans_tpu_torch.nn.model import NHANSNet
    from nhans_tpu_torch.ops import tower_conv as tc

    ops = []

    def counting(x, w, b, stride, pads):
        y = F.conv2d(F.pad(x, pads), w, b, stride=stride)
        direct = 2 * y.numel() * w[0].numel()
        unit = tuple(stride) == (1, 1) and x.requires_grad
        ops.append(direct * (2 + unit) + (y.numel() if b is not None
                                          else 0))
        return y

    monkeypatch.setattr(nn_model, "KERNEL_DEVICES", ("meta",))
    monkeypatch.setattr(tc.TrainConv, "apply", counting)
    # the epilogues on the modules: their kernels take no meta tensor
    monkeypatch.setattr(nn_model, "_train_epilogue",
                        nn_model._epilogue_modules)
    with torch.device("meta"):
        model = NHANSNet(port_config(CFG).model).train()
        model(torch.zeros(1, 35, 201), torch.zeros(1, 200, 201),
              torch.zeros(1, 200, 201))
    assert len(ops) == 16 + 2 * 8 and len(list(train_convs(CFG))) == 24
    assert step_conv_flops(CFG, 1) == sum(ops)
    assert step_conv_flops(CFG, 64) == 64 * sum(ops)
    assert step_conv_flops(CFG, 64) < train_step_flops(CFG, 64)


def test_reads_the_traced_steps_kernel_share(recorded):
    recorded += [_forward(s, 24, 1 + 2 * s) for s in range(3)]
    trace = KernelTrace(0.4, 0.3)
    got = read(_facts(), trace)
    assert got == pytest.approx(
        100 * 3 * step_conv_flops(CFG, 64) / 67e12 / 0.7, rel=1e-12)
    assert 0 < got < 100
    # 16 windows a step: the yardstick follows the run's step FLOPs
    assert read(_facts(16), trace) == pytest.approx(got / 4, rel=1e-12)


def test_reads_none_where_the_kernels_did_not_run(recorded):
    recorded += [_forward(s, 24, 1 + 2 * s) for s in range(3)]
    trace = KernelTrace(0.4, 0.3)
    assert read(_facts(), None) is None
    assert read({}, trace) is None
    assert read(_facts(step_flops=train_step_flops(CFG, 64) + 1),
                trace) is None
    assert read(_facts(device_kind="cpu"), trace) is None
    assert read(_facts(), KernelTrace(0.0, 0.0)) is None
    # the parent: spans without the count, or a step off float32
    recorded[:] = [_forward(s, 0, 1 + 2 * s) for s in range(3)]
    assert read(_facts(), trace) is None
    recorded.clear()
    assert read(_facts(), trace) is None
