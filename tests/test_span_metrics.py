"""The per-layer metrics that read the program's spans
(benchmark/metrics/{serve_pad_pct, call_enqueue_ms, call_idle_enqueue_pct,
update_ms, train_idle_update_pct}.py) on a stub trace and synthetic spans,
with exact values; without their traced_* fact, or against a program
without the recorder, they read None.  Last, serve_pad_pct on the folder
cell's traced batches, served on the CPU by the engine (its model's
residuals stubbed out: no count depends on them): 0, since the engine
computes no padding window, and its skipped windows the share the lengths
and the engine's buckets give."""

import sys
import types

import numpy as np
import pytest

from benchmark import harness, traffic
from nhans_tpu_torch.utils import spans

MS = 1_000_000


class StubTrace:
    def __init__(self, start_ns, end_ns, gaps=()):
        self.start_ns, self.end_ns, self._gaps = start_ns, end_ns, list(gaps)

    def gaps(self):
        return list(self._gaps)

    @property
    def window_s(self):
        return (self.end_ns - self.start_ns) / 1e9


def _span(name, id, t0_ms, t1_ms, device_ms=None, **counts):
    return types.SimpleNamespace(name=name, id=id, start_ns=int(t0_ms * MS),
                                 end_ns=int(t1_ms * MS), counts=counts,
                                 device_ms=device_ms, parent=None)


@pytest.fixture
def recorded(monkeypatch):
    """Plant synthetic spans where the readers find the program's."""
    planted = []

    def between(t0, t1):
        return sorted((s for s in planted
                       if s.start_ns >= t0 and s.end_ns <= t1),
                      key=lambda s: s.start_ns)

    monkeypatch.setattr(spans, "between", between)
    return planted


def read(name, facts, trace):
    return harness.load_module("metrics", name).read(facts, trace)


def test_serve_pad_pct_pairs_each_batchs_counts(recorded, capsys):
    recorded += [
        _span("enhance.dispatch", 1, 1, 2, real_windows=100),
        _span("enhance.run", 1, 2, 3, windows=64),
        _span("enhance.run", 1, 3, 4, windows=64),      # a second device
        _span("enhance.dispatch", 2, 5, 6, real_windows=50),
        _span("enhance.run", 2, 6, 7, windows=64),
        _span("enhance.dispatch", 3, 8, 9, real_windows=30),  # no run here
        _span("enhance.run", 0, -3, -2, windows=999),   # before the window
        _span("enhance.materialize", 1, 7, 8),
    ]
    trace = StubTrace(0, 10 * MS)
    got = read("serve_pad_pct", {"traced_batches": 3}, trace)
    assert got == pytest.approx(100 * (1 - 150 / 192), abs=1e-12)
    assert capsys.readouterr().err == (
        "serve_pad_pct: traced batches (id, real windows, windows): "
        "(1, 100, 128), (2, 50, 64)\n")
    assert read("serve_pad_pct", {}, trace) is None
    assert read("serve_pad_pct", {"traced_batches": 3}, None) is None


def test_call_enqueue_ms_and_its_idle_share(recorded):
    recorded += [_span("enhance.launch", 1, 15, 55),
                 _span("enhance.contexts", 1, 15, 16),
                 _span("enhance.launch", 2, 95, 97),
                 _span("enhance.dispatch", 2, 90, 95)]
    gaps = [(10 * MS, 20 * MS), (50 * MS, 60 * MS), (90 * MS, 100 * MS)]
    trace = StubTrace(0, 100 * MS, gaps)
    facts = {"traced_calls": 2}
    assert read("call_enqueue_ms", facts, trace) == pytest.approx(21.0)
    # 5 ms of the first gap, 5 of the second, 2 of the third
    assert read("call_idle_enqueue_pct", facts, trace) == pytest.approx(12.0)
    for name in ("call_enqueue_ms", "call_idle_enqueue_pct"):
        assert read(name, {}, trace) is None
        assert read(name, facts, None) is None


def test_update_ms_and_its_idle_share(recorded):
    recorded += [_span("train.update", 0, 10, 40, device_ms=4.0),
                 _span("train.backward", 0, 5, 10, device_ms=9.0),
                 _span("train.update", 1, 60, 80, device_ms=6.0)]
    gaps = [(0, 15 * MS), (35 * MS, 70 * MS)]
    trace = StubTrace(0, 200 * MS, gaps)
    facts = {"traced_steps": 2}
    assert read("update_ms", facts, trace) == pytest.approx(5.0)
    # 5 ms + 5 ms + 10 ms of 200
    assert read("train_idle_update_pct", facts, trace) == pytest.approx(10.0)
    for name in ("update_ms", "train_idle_update_pct"):
        assert read(name, {}, trace) is None
        assert read(name, facts, None) is None


NAMES_FACTS = [("serve_pad_pct", "traced_batches"),
               ("call_enqueue_ms", "traced_calls"),
               ("call_idle_enqueue_pct", "traced_calls"),
               ("update_ms", "traced_steps"),
               ("train_idle_update_pct", "traced_steps")]


@pytest.mark.parametrize("name,fact", NAMES_FACTS)
def test_a_program_without_the_recorder_reads_none(name, fact, monkeypatch):
    monkeypatch.setitem(sys.modules, "nhans_tpu_torch.utils.spans", None)
    assert read(name, {fact: 3}, StubTrace(0, 10 * MS, [(0, 10 * MS)])) \
        is None


@pytest.mark.parametrize("name,fact", NAMES_FACTS)
def test_no_span_of_the_metric_reads_none(name, fact, recorded):
    recorded.append(_span("other", 1, 1, 2))
    assert read(name, {fact: 3}, StubTrace(0, 10 * MS, [(0, 10 * MS)])) \
        is None


def test_serve_pad_pct_of_the_folder_cells_traced_batches(monkeypatch):
    """The folder cell's batches in the name order deal_seed 10 draws; the
    traced ones are the second to fourth of a folder (buckets 7, 16 and
    12 s).  The engine serves them on the CPU and computes only their real
    windows, so the reader reads 0; the windows it skips are the share of
    the rows x bucket frames that their lengths and the engine's buckets
    give."""
    import torch

    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.infer import enhance
    from tests.test_torch_spans import _small

    run = harness.open_run("denoiser.folder", 1, 1.0, True, device="cpu")
    tp, sr = run.workload["traffic_params"], run.config["sample_rate"]
    lengths = traffic.quantile_lengths(tp["files"], sample_rate=sr,
                                       **tp["length_s"])
    batches = traffic.name_order_batches(np.random.default_rng(0),
                                         tp["files"], tp["batch"],
                                         tp["deal_seed"])[1:4]
    a = Config.denoiser().audio
    buckets = [int(s * sr) for s in enhance.DEFAULT_BUCKETS_SECONDS]
    real = computed = 0
    picked = []
    for b in batches:
        n = [a.trim_to_whole_frames(int(lengths[i])) for i in b]
        bucket = min(x for x in buckets if x >= max(n))
        picked.append(bucket / sr)
        real += sum(a.num_frames(x) for x in n)
        computed += len(b) * a.num_frames(bucket)
    assert picked == [7, 16, 12]
    want = 100 * (1 - real / computed)

    monkeypatch.setattr(enhance, "window_residuals",
                        lambda model, logmag, *rest, **kw:
                        torch.zeros_like(logmag))
    cfg = _small()
    from nhans_tpu_torch.nn.model import NHANSNet
    enh = enhance.Enhancer(cfg, NHANSNet(cfg.model).state_dict(),
                           device="cpu")
    rng = np.random.default_rng(3)
    pos, neg = rng.standard_normal(4 * sr) * 700, rng.standard_normal(
        4 * sr) * 900
    feed = [([rng.standard_normal(int(lengths[i])) * 2000 for i in b],
             [pos] * len(b), [neg] * len(b)) for b in batches]
    spans.drain()
    with spans.recording():
        start = spans.time.time_ns()
        for _ in enh.enhance_stream(iter(feed), depth=2):
            pass
        end = spans.time.time_ns()
    try:
        got = read("serve_pad_pct", {"traced_batches": 3},
                   StubTrace(start, end))
    finally:
        runs = [s for s in spans.drain() if s.name == "enhance.run"]
    assert got == 0
    windows = sum(s.counts["windows"] for s in runs)
    skipped = sum(s.counts["skipped_windows"] for s in runs)
    assert windows == real and windows + skipped == computed
    assert 100 * skipped / computed == pytest.approx(want, abs=1e-9)
    assert 55 < want < 65


class KernelTrace(StubTrace):
    """A stub trace whose ``tower_epilogue`` kernels took ``epilogue_s``."""

    def __init__(self, start_ns, end_ns, epilogue_s):
        super().__init__(start_ns, end_ns)
        self.epilogue_s = epilogue_s

    def kernel_s(self, fragment):
        return self.epilogue_s if fragment == "tower_epilogue" else 0.0


def _folder_flops():
    from benchmark import epilogue_bytes, flops

    return flops.window_flops(epilogue_bytes.cell_config("denoiser.folder"))


H100 = {"traced_batches": 3, "device_kind": "NVIDIA H100 80GB HBM3",
        "dtype": "float32", "window_flops": _folder_flops()}


def test_epilogue_roofline_reads_the_traced_windows_bytes(recorded):
    recorded += [_span("enhance.run", 1, 1, 2, windows=1000),
                 _span("enhance.run", 2, 3, 4, windows=500),
                 _span("enhance.dispatch", 2, 2, 3, real_windows=500),
                 _span("enhance.run", 0, -3, -2, windows=999)]
    trace = KernelTrace(0, 10 * MS, 0.025)
    got = read("epilogue_roofline.serve", H100, trace)
    # 5 transfers of 1,734,016 float32 a window, 1,500 windows
    assert got == pytest.approx(100 * 1500 * 5 * 1734016 * 4
                                / 3.35e12 / 0.025, rel=1e-12)
    assert 0 < got < 100
    # the run's own item size; another tower's widths read nothing
    assert read("epilogue_roofline.serve", dict(H100, dtype="bfloat16"),
                trace) == pytest.approx(got / 2, rel=1e-12)
    assert read("epilogue_roofline.serve",
                dict(H100, window_flops=H100["window_flops"] + 1),
                trace) is None
    assert read("epilogue_roofline.serve", {}, trace) is None
    assert read("epilogue_roofline.serve", H100, None) is None
    assert read("epilogue_roofline.serve", dict(H100, device_kind="cpu"),
                trace) is None
    # the parent: no such kernel in the trace
    assert read("epilogue_roofline.serve", H100,
                KernelTrace(0, 10 * MS, 0.0)) is None


def test_epilogue_roofline_without_the_spans_reads_none(recorded,
                                                        monkeypatch):
    recorded.append(_span("other", 1, 1, 2))
    trace = KernelTrace(0, 10 * MS, 0.025)
    assert read("epilogue_roofline.serve", H100, trace) is None
    monkeypatch.setitem(sys.modules, "nhans_tpu_torch.utils.spans", None)
    assert read("epilogue_roofline.serve", H100, trace) is None


def test_epilogue_bytes_are_the_ports_block_outputs():
    """The yardstick's elements per window equal the outputs of the port's
    eight blocks at full width, and the cell's configuration is the
    denoiser's."""
    import torch

    from benchmark import epilogue_bytes
    from benchmark.serving import port_config
    from nhans_tpu_torch.nn.model import CondResBlock, NHANSNet

    cfg = epilogue_bytes.cell_config("denoiser.folder")
    assert cfg["name"] == "nhans-denoiser"
    model = NHANSNet(port_config(cfg).model)
    sizes = []
    for block in model.modules():
        if isinstance(block, CondResBlock):
            block.register_forward_hook(
                lambda m, i, o: sizes.append(o.numel()))
    with torch.inference_mode():
        model(torch.zeros(1, 35, 201), emb_a=torch.zeros(1, 512),
              emb_b=torch.zeros(1, 512))
    assert len(sizes) == 8
    assert sum(sizes) == epilogue_bytes.activation_elements(cfg) == 1734016
    assert epilogue_bytes.window_bytes(cfg, "float32") == 5 * 1734016 * 4
    assert epilogue_bytes.window_bytes(cfg, "bfloat16") == 5 * 1734016 * 2


class ConvTrace(StubTrace):
    """A stub trace whose ``tower_conv`` kernels took ``conv_s``."""

    def __init__(self, start_ns, end_ns, conv_s):
        super().__init__(start_ns, end_ns)
        self.conv_s = conv_s

    def kernel_s(self, fragment):
        return self.conv_s if fragment == "tower_conv" else 0.0


def test_conv_roofline_reads_the_traced_windows_flops(recorded):
    recorded += [_span("enhance.run", 1, 1, 2, windows=1000),
                 _span("enhance.run", 2, 3, 4, windows=500),
                 _span("enhance.run", 0, -3, -2, windows=999)]
    trace = ConvTrace(0, 10 * MS, 0.5)
    got = read("conv_roofline.serve", H100, trace)
    # 10,158,790,656 direct operations a window, 1,500 windows
    assert got == pytest.approx(100 * 1500 * 10158790656 / 67e12 / 0.5,
                                rel=1e-12)
    assert 0 < got < 100
    # only the float32 tower of the cell's widths, on a known card
    assert read("conv_roofline.serve", dict(H100, dtype="bfloat16"),
                trace) is None
    assert read("conv_roofline.serve",
                dict(H100, window_flops=H100["window_flops"] + 1),
                trace) is None
    assert read("conv_roofline.serve", {}, trace) is None
    assert read("conv_roofline.serve", H100, None) is None
    assert read("conv_roofline.serve", dict(H100, device_kind="cpu"),
                trace) is None
    # the parent: no such kernel in the trace
    assert read("conv_roofline.serve", H100,
                ConvTrace(0, 10 * MS, 0.0)) is None
    # without the spans, or against a program without the recorder
    recorded.clear()
    assert read("conv_roofline.serve", H100, trace) is None


def test_window_conv_flops_are_the_ports_tower_convolutions(monkeypatch):
    """The yardstick's operations per window equal two per multiply-add of
    the port's sixteen k x k convolutions at full width, counted from the
    shapes a forward of the model hands them."""
    import torch

    from benchmark import epilogue_bytes
    from benchmark.conv_flops import window_conv_flops
    from benchmark.serving import port_config
    from nhans_tpu_torch.nn import model as nn_model
    from nhans_tpu_torch.nn.model import NHANSNet

    cfg = epilogue_bytes.cell_config("denoiser.folder")
    model = NHANSNet(port_config(cfg).model)
    macs = []
    real = nn_model.tower_conv

    def counting(x, w, b, stride, pads):
        y = real(x, w, b, stride, pads)
        macs.append(y.numel() * w[0].numel())
        return y

    monkeypatch.setattr(nn_model, "tower_conv", counting)
    with torch.inference_mode():
        model(torch.zeros(1, 35, 201), emb_a=torch.zeros(1, 512),
              emb_b=torch.zeros(1, 512))
    assert len(macs) == 16
    assert window_conv_flops(cfg) == 2 * sum(macs) == 10158790656
