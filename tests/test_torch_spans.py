"""The span and count recorder (nhans_tpu_torch/utils/spans.py) on the
CPU, and the spans the serving engine and the train step record.

Off, a span is the shared no-op and touches neither the clock nor the
profiler.  On, under torch's profiler or ``spans.recording()``, it keeps
its name, parent, id and counts, and under the profiler its
``record_function`` event lies within 1 ms of the recorder's own start and
end.  The engine's counts are held to hand counts: a batch of 3 padded to
4 rows on a half-second bucket, and the segment groups of
``enhance_long``.  The models are narrow: no count depends on a width.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.infer import enhance
from nhans_tpu_torch.models import init_variables
from nhans_tpu_torch.nn.model import NHANSNet
from nhans_tpu_torch.train.step import (make_train_step, make_tx, state_of,
                                        step_generator)
from nhans_tpu_torch.utils import spans

SMALL_MODEL = dict(
    window_frames=9, context_frames=20, embedding_dim=16,
    pos_embed_hidden=8,
    main_blocks=((3, 1, 8), (3, 2, 16)),
    context_blocks=(((4, 4), (2, 2), 8), ((3, 3), (1, 2), 16)))
SR = 16000


@pytest.fixture(autouse=True)
def _empty_ring():
    spans.drain()
    yield
    spans.drain()


def _small(task="denoiser", **data):
    cfg = getattr(Config, task)()
    return cfg.replace(model=dataclasses.replace(cfg.model, **SMALL_MODEL),
                       data=dataclasses.replace(cfg.data, **data))


def test_off_a_span_is_the_shared_no_op(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("touched while nothing records")

    assert not spans.profiling()
    monkeypatch.setattr(spans.time, "time_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    s = spans.span("x", id=3, device="cuda", n=1)
    assert s is spans.OFF
    with spans.span("outer", id=1) as outer:
        outer.count(n=2)
        with spans.span("inner"):
            pass
    monkeypatch.undo()
    assert spans.drain() == []


def _kineto(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_on_names_parents_ids_counts(how, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counted(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    scope = (profile(activities=[ProfilerActivity.CPU])
             if how == "profiler" else spans.recording())
    with scope as prof:
        with spans.span("outer", id=7, rows=4) as outer:
            outer.count(rows=1, calls=1)
            with spans.span("inner", id=7, windows=12):
                torch.ones(64).sum()
            with spans.span("second", id=7):
                pass
    assert not spans.profiling()
    got = spans.drain()
    assert [s.name for s in got] == ["outer", "inner", "second"]
    outer, inner, second = got
    assert outer.parent is None
    assert inner.parent is outer and second.parent is outer
    assert {s.id for s in got} == {7}
    assert outer.counts == {"rows": 5, "calls": 1}
    assert inner.counts == {"windows": 12} and second.counts == {}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= second.start_ns <= second.end_ns <= outer.end_ns
    assert all(s.device_ms is None for s in got)
    if how == "recording":
        assert opened == []
        return
    assert opened == ["outer", "inner", "second"]
    events = _kineto(prof)
    for s in got:
        near = [(a, b) for n, a, b in events if n == s.name
                and abs(a - s.start_ns) < 1_000_000
                and abs(b - s.end_ns) < 1_000_000]
        assert near, (s, [e for e in events if e[0] == s.name])


def test_the_profiler_helper_is_torchs_flag():
    """``profiling()`` reads torch.autograd.profiler._is_profiler_enabled,
    which torch sets on a profile's start and clears on its stop: a
    torch that moves or renames it fails here."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    assert spans.profiling() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert spans.profiling() is True
    assert spans.profiling() is False
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert spans.profiling() is True
    finally:
        prof.stop()
    assert spans.profiling() is False


def test_the_ring_keeps_the_newest_spans():
    with spans.recording():
        for i in range(spans.RING + 10):
            with spans.span("s", id=i):
                pass
    got = spans.drain()
    assert len(got) == spans.RING
    assert [s.id for s in got[:2]] == [10, 11] and got[-1].id == spans.RING + 9
    assert spans.drain() == []


def test_between_keeps_the_spans_inside_the_stretch():
    with spans.recording():
        for i in range(3):
            with spans.span("s", id=i):
                pass
    first, second, third = spans.between(0, 2 ** 63)
    assert [s.id for s in spans.between(second.start_ns, second.end_ns)] == [1]
    assert [s.id for s in spans.between(first.start_ns, third.end_ns)] \
        == [0, 1, 2]
    assert spans.between(first.start_ns + 1, third.end_ns - 1) == [second]


def test_two_threads_do_not_mix_their_parents():
    barrier = threading.Barrier(2, timeout=60)

    def work(tag):
        with spans.span(f"{tag}.outer", id=tag):
            barrier.wait()
            for i in range(300):
                with spans.span(f"{tag}.inner", id=tag):
                    with spans.span(f"{tag}.leaf", id=tag):
                        pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording():
            threads = [threading.Thread(target=work, args=(t,))
                       for t in ("a", "b")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = spans.drain()
    assert len(got) == 2 * 601
    outers = {s.id: s for s in got if s.name.endswith(".outer")}
    for s in got:
        if s.name.endswith(".inner"):
            assert s.parent is outers[s.id]
        elif s.name.endswith(".leaf"):
            assert s.parent.name == f"{s.id}.inner"
            assert s.parent.parent is outers[s.id]


def _enhancer(buckets=(0.5, 1.0)):
    cfg = _small()
    return enhance.Enhancer(cfg, NHANSNet(cfg.model).state_dict(),
                            window_chunk=64, buckets_seconds=buckets,
                            device="cpu")


def _noise(rng, n, scale=2000.0):
    return rng.standard_normal(n) * scale


def test_a_batch_of_three_padded_to_four_counts_its_windows():
    """Lengths 4800, 7200 and 3200 samples: 28, 43 and 18 frames of
    400 samples every 160, 89 real; the 0.5 s bucket (8000 samples, 48
    frames) times 4 rows holds 192 windows, of which the tower computes
    the 89 real ones and skips 103."""
    enh = _enhancer()
    rng = np.random.default_rng(0)
    mixed = [_noise(rng, n) for n in (4800, 7200, 3200)]
    pos, neg = _noise(rng, 3000, 700), _noise(rng, 9000, 1500)
    with spans.recording():
        enh.enhance_batch(mixed, [pos] * 3, [neg] * 3)
        enh.enhance_batch(mixed[:1], [pos], [neg])
    got = spans.drain()
    first = [s for s in got if s.id == 1]
    assert [s.name for s in first] == [
        "enhance.dispatch", "enhance.launch", "enhance.contexts",
        "enhance.run", "enhance.materialize"]
    dispatch, launch, contexts, run, materialize = first
    assert dispatch.counts == {"real_windows": 28 + 43 + 18}
    assert run.counts == {"windows": 89, "skipped_windows": 4 * 48 - 89}
    assert contexts.counts == {}
    assert dispatch.parent is None and materialize.parent is None
    assert launch.parent is None
    assert contexts.parent is launch and run.parent is launch
    # one row, its own 28 frames on the 0.5 s bucket
    second = {s.name: s for s in got if s.id == 2}
    assert second["enhance.dispatch"].counts == {"real_windows": 28}
    assert second["enhance.run"].counts == {"windows": 28,
                                            "skipped_windows": 20}
    with spans.recording():
        enh.enhance_batch(mixed[1:2], [pos], [neg])
    third = {s.name: s for s in spans.drain()}
    assert third["enhance.contexts"].parent is third["enhance.launch"]
    assert third["enhance.dispatch"].counts == {"real_windows": 43}
    assert third["enhance.dispatch"].id == 3


def test_enhance_long_counts_the_frames_of_its_segments():
    """2 s (198 frames) in 0.5 s segments (48 frames, 4-frame halos, cores
    of 40): cores at frames 0, 40, 80, 120, 160; groups of 4 rows.  The
    first group's segments hold 44, 48, 48 and 48 frames, the second's
    one row 42 (38 core frames and a halo) and three empty rows.  Each
    group's rows x frames are 4 x 48; the tower computes only the core
    frames, 160 and 38, and skips the halos and empty rows."""
    enh = _enhancer(buckets=(0.5,))
    rng = np.random.default_rng(1)
    with spans.recording():
        enh.enhance_long(_noise(rng, 32000), _noise(rng, 3000, 700),
                         _noise(rng, 9000, 1500), segment_seconds=0.5,
                         segment_batch=4)
    got = spans.drain()
    dispatch = [s for s in got if s.name == "enhance.dispatch"]
    run = [s for s in got if s.name == "enhance.run"]
    assert [s.counts for s in dispatch] == [{"real_windows": 160},
                                            {"real_windows": 38}]
    assert [s.counts for s in run] == [
        {"windows": 160, "skipped_windows": 32},
        {"windows": 38, "skipped_windows": 154}]
    assert [s.id for s in dispatch] == [s.id for s in run] == [1, 2]
    contexts = [s for s in got if s.name == "enhance.contexts"]
    assert [s.id for s in contexts] == [1, 2]
    assert [s.name for s in got if s.id == 2] == [
        "enhance.dispatch", "enhance.launch", "enhance.contexts",
        "enhance.run", "enhance.materialize"]


def test_a_train_step_records_one_step_of_four_phases():
    L = 400 + 160 * 40
    cfg = _small("separator", max_samples=L, slices_per_step=2)
    g = torch.Generator()
    g.manual_seed(0)
    model = init_variables(cfg, g, "cpu")
    tx = make_tx(cfg)
    state = state_of(model, tx)
    step = make_train_step(cfg, model, tx, banked=True)
    rng = np.random.default_rng(2)
    rows = torch.from_numpy(np.rint(rng.standard_normal((4, L + 700))
                                    * 3000).astype(np.int16))
    lens = torch.tensor([L, L - 900, L + 700, L - 300], dtype=torch.int32)
    peaks = rows.abs().amax(dim=1).to(torch.float32)
    banks = {f"{k}{s}": v for k in ("speech", "noise")
             for s, v in (("", rows), ("_len", lens), ("_peak", peaks))}
    idx = {"clean_idx": torch.tensor([0, 1], dtype=torch.int32),
           "a_idx": torch.tensor([2, 3], dtype=torch.int32),
           "b_idx": torch.tensor([3, 0], dtype=torch.int32)}
    with spans.recording():
        for t in range(2):
            step(state, banks, idx, step_generator(0, t))
    got = spans.drain()
    steps = [s for s in got if s.name == "train.step"]
    assert [s.id for s in steps] == [0, 1]
    for whole in steps:
        inside = [s for s in got if s.parent is whole]
        assert [s.name for s in inside] == ["train.batch", "train.forward",
                                            "train.backward", "train.update"]
        assert all(s.id == whole.id for s in inside)
        ends = [whole.start_ns] + [x for s in inside
                                   for x in (s.start_ns, s.end_ns)]
        assert ends == sorted(ends) and ends[-1] <= whole.end_ns
    assert len(got) == 2 * 5


def test_kernel_summary_leaves_out_the_spans_device_ranges():
    """Under CPU and CUDA activity kineto gives each ``record_function``
    range a device row of its own; the profiling tools' kernel summary
    counts kernels only."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from nhans_tpu_torch.tools.devtime import kernel_summary

    def row(key, device_type, us, count, note=False):
        return SimpleNamespace(key=key, device_type=device_type,
                               self_device_time_total=us, count=count,
                               is_user_annotation=note)

    rows = [row("train.update", DeviceType.CUDA, 9000.0, 2, note=True),
            row("void gemm_kernel", DeviceType.CUDA, 3000.0, 4),
            row("aten::add_", DeviceType.CPU, 0.0, 9),
            row("Buffer Flush", DeviceType.CUDA, 50.0, 1),
            row("elementwise_kernel", DeviceType.CUDA, 1000.0, 6)]
    got = kernel_summary(SimpleNamespace(key_averages=lambda: rows), per=2)
    assert [e.key for e in got["rows"]] == ["void gemm_kernel",
                                            "elementwise_kernel"]
    assert got["busy_ms"] == 2.0 and got["launches"] == 5.0


@pytest.mark.gpu
def test_a_device_span_times_its_stream_on_the_card():
    """On a card a span with a device times its stream by CUDA events: a
    sleep kernel of about a millisecond inside reads its length, and the
    parent's device time holds the child's.  On the card:
    ``python -m pytest --noconftest -m gpu tests/test_torch_spans.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with spans.recording():
        with spans.span("outer", device="cuda") as outer:
            with spans.span("inner", device="cuda") as inner:
                torch.cuda._sleep(2_000_000)
    assert 0.3 < inner.device_ms < 100
    assert outer.device_ms >= inner.device_ms
    assert inner.host_ms < inner.device_ms
