"""The port's benchmark harness (nhans_tpu_torch/bench.py) against the root
bench.py, on the CPU.

* Inputs: the root bench.py runs its three modes at tiny sizes with the
  JAX model replaced by recorders (``nhans_tpu.infer.enhance.Enhancer``,
  ``nhans_tpu.models.init_variables``,
  ``nhans_tpu.train.step.create_state``/``make_train_step``); what it feeds
  them equals the port's input builders exactly: the synthetic and the
  DEMO serving batch, the streamed batch and the banks with their index
  triples, and every suite call, the five-minute tiling included.
* Result lines: each of the port's lines carries bench.py's keys, less
  infer's ``vs_baseline``, plus the card fields ``main`` adds.
* End to end at narrow widths, with seeded weights carried from flax by
  ``compat/weights.py``: the harness's serving (``enhance_stream`` after a
  warm batch) and its segmented long call give the JAX Enhancer's
  waveforms within 1e-4 (peak about 1; snr_est 1e-4 relative), and its
  training run's first loss equals the port's ``make_train_step`` on the
  same inputs exactly (the same float32 arithmetic in the same order).
* The FLOP count of a narrow forward pass equals 2 x the multiply-adds of
  its convolutions and dense layers, computed from their shapes, exactly.
* Without a card ``python -m nhans_tpu_torch.bench`` exits non-zero and
  prints no result line.
"""

import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhans_tpu.infer.enhance import Enhancer as JEnhancer
from nhans_tpu_torch import bench
from nhans_tpu_torch.compat.weights import from_flax
from nhans_tpu_torch.models import build_model
from nhans_tpu_torch.nn.blocks import Conv, Dense
from nhans_tpu_torch.train.step import create_state, make_train_step
from tests.make_torch_golden import twin_configs, write_reference_tree
from tests.test_torch_train_step import SMALL_MODEL, _nest, _variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE_ATOL = 1e-4
SNR_RTOL = 1e-4
TREE_SECONDS = 0.5
INFER = ["--batch", "3", "--seconds", "0.5", "--iters", "2"]
TRAIN = ["--train_utts", "2", "--iters", "1"]
SUITE = ["--iters", "1"]
NARROW_DATA = dict(max_samples=400 + 160 * 40, slices_per_step=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """Stand-ins for the JAX model that record what bench.py feeds it."""

    def __init__(self):
        self.calls = []

    def enhancer(self):
        rec = self

        class Enhancer:
            def __init__(self, cfg, variables, window_chunk=2048, **kw):
                self.task = cfg.task.name
                rec.calls.append(("init", self.task, window_chunk))

            def enhance_batch(self, mixed, pos, neg):
                rec.calls.append(("batch", self.task,
                                  (list(mixed), list(pos), list(neg))))
                return {"denoised": [np.zeros(4)]}

            def enhance_stream(self, batches):
                for mixed, pos, neg in batches:
                    rec.calls.append(("stream", self.task,
                                      (list(mixed), list(pos), list(neg))))
                    yield {"denoised": [np.zeros(4)]}

            def enhance_long(self, mixed, pos, neg):
                rec.calls.append(("long", self.task, (mixed, pos, neg)))
                return {"denoised": np.zeros(4)}

        return Enhancer

    def create_state(self, cfg, key):
        return None, jnp.zeros(()), None

    def make_train_step(self, cfg, model, tx, donate=False, banked=False):
        def step(state, *args):
            if not isinstance(state, jax.core.Tracer):  # not while lowering
                self.calls.append(("step", banked, [
                    {k: np.asarray(v) for k, v in a.items()}
                    for a in args[:-1]]))
            return state, {"loss": jnp.zeros(())}
        return step


def _run_root_bench(argv, monkeypatch):
    """(recorded calls, printed line) of the root bench.py's ``main``."""
    rec = _Recorder()
    monkeypatch.setattr("nhans_tpu.infer.enhance.Enhancer", rec.enhancer())
    monkeypatch.setattr("nhans_tpu.models.init_variables",
                        lambda cfg, key, train=False: (None, None))
    monkeypatch.setattr("nhans_tpu.train.step.create_state", rec.create_state)
    monkeypatch.setattr("nhans_tpu.train.step.make_train_step",
                        rec.make_train_step)
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        root.main()
    return rec.calls, json.loads(out.getvalue().splitlines()[-1])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    write_reference_tree(str(root), np.random.default_rng(7), TREE_SECONDS)
    return str(root)


@pytest.fixture(scope="module")
def root_runs(tree, tmp_path_factory):
    """The root bench.py's recorded calls and lines, by run."""
    empty = str(tmp_path_factory.mktemp("no_reference"))
    runs = {
        "infer_synthetic": ["--mode", "infer", "--reference_root", empty,
                            *INFER],
        "infer_demo": ["--mode", "infer", "--reference_root", tree, *INFER],
        "train_streamed": ["--mode", "train", *TRAIN],
        "train_banked": ["--mode", "train", "--banked", *TRAIN],
        "suite": ["--mode", "suite", "--reference_root", tree, *SUITE],
    }
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, argv in runs.items():
            out[name] = (*_run_root_bench(argv, mp), bench.parse_args(argv))
    return out


def _same(got, want, what):
    """Equal arrays, list for list, exactly."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        assert np.array_equal(g, w), (what, i)


@pytest.mark.parametrize("run", ["infer_synthetic", "infer_demo"])
def test_infer_inputs_equal_bench_py(root_runs, run):
    calls, line, args = root_runs[run]
    mixed, pos, neg, source = bench.infer_inputs(args, 16000)
    assert source == line["audio_source"]
    assert source == ("synthetic" if run == "infer_synthetic"
                      else "demo7_real")
    fed = [c for c in calls if c[0] in ("batch", "stream")]
    # one warm enhance_batch, then --iters batches through enhance_stream
    assert [c[0] for c in fed] == ["batch"] + ["stream"] * args.iters
    for _, task, (m, p, n) in fed:
        assert task == "denoiser"
        _same(m, mixed, "mixed")
        _same(p, pos, "pos")
        _same(n, neg, "neg")


@pytest.mark.parametrize("run", ["train_streamed", "train_banked"])
def test_train_inputs_equal_bench_py(root_runs, run):
    calls, line, args = root_runs[run]
    _, tcfg = twin_configs("denoiser")
    want = bench.train_inputs(args, tcfg)
    steps = [c for c in calls if c[0] == "step"]
    assert len(steps) == 1 + args.iters
    for _, banked, fed in steps:
        assert banked == args.banked
        parts = ([want["banks"], want["idx"]] if args.banked
                 else [want["batch"]])
        assert len(fed) == len(parts)
        for got, ref in zip(fed, parts):
            assert list(got) == list(ref)
            for k in ref:
                _same([got[k]], [ref[k]], k)
    assert line["pipeline"] == ("banked" if args.banked else "streamed")
    assert line["windows_per_step"] == args.train_utts * 4


def test_suite_inputs_equal_bench_py(root_runs, tree):
    calls, line, args = root_runs["suite"]
    batches, long = bench.suite_inputs(tree)
    assert list(line["configs"]) == [*batches, "long_audio_5min_segmented"]
    fed = [c for c in calls if c[0] in ("batch", "long")]
    # each batch config: a warm call and --iters timed ones; the long
    # path: a warm call and one timed
    want = [("batch", task, (m, a, b)) for task, m, a, b in batches.values()
            for _ in range(1 + args.iters)]
    want += [("long", "denoiser", long)] * 2
    assert [c[:2] for c in fed] == [c[:2] for c in want]
    for (kind, _, got), (_, _, ref) in zip(fed, want):
        for g, r, what in zip(got, ref, ("mixed", "pos", "neg")):
            _same(g, r, what) if kind == "batch" else _same([g], [r], what)
    assert len(long[0]) == bench.LONG_SECONDS * 16000
    assert len(batches["folder_batch_demo7"][1]) == 7


def test_suite_refuses_without_the_tree(tmp_path):
    with pytest.raises(SystemExit, match="reference audio tree"):
        bench.suite_inputs(str(tmp_path))
    with pytest.raises(SystemExit, match="reference audio tree"):
        bench.suite_inputs("")


# --------------------------------------------------------------------- #
# narrow widths, end to end
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def narrow():
    """(JAX Config, port Config, flax variables, port state_dict): the
    reduced model with seeded weights, the zero-initialised layers given
    values so that the tower's output reaches the waveforms."""
    jcfg, tcfg = twin_configs("denoiser", model=SMALL_MODEL,
                              data=NARROW_DATA)
    flat = _variables(jcfg, seed=11)
    variables = {
        "params": _nest({k[7:]: v for k, v in flat.items()
                         if k.startswith("params/")}),
        "batch_stats": _nest({k[12:]: v for k, v in flat.items()
                              if k.startswith("batch_stats/")})}
    return jcfg, tcfg, variables, from_flax(flat)


def _assert_waves(got, ref, batch=True):
    for key in ("denoised", "mixed_processed", "removed"):
        g, r = (got[key], ref[key]) if batch else ([got[key]], [ref[key]])
        assert len(g) == len(r), key
        for gi, ri in zip(g, r):
            assert np.shape(gi) == np.shape(ri), key
            np.testing.assert_allclose(gi, ri, atol=WAVE_ATOL, err_msg=key)
    np.testing.assert_allclose(got["snr_est"], ref["snr_est"], rtol=SNR_RTOL)


def test_serving_matches_jax_at_narrow_width(narrow, root_runs):
    jcfg, tcfg, variables, state = narrow
    _, root_line, args = root_runs["infer_synthetic"]
    line, out = bench.bench_infer(args, "cpu", cfg=tcfg, weights=state)
    mixed, pos, neg, _ = bench.infer_inputs(args, 16000)
    jenh = JEnhancer(jcfg, variables, out_wire="float32",
                     window_chunk=args.window_chunk)
    _assert_waves(out, jenh.enhance_batch(mixed, pos, neg))
    # the tower reaches the output: not the identity enhancement
    assert max(np.abs(d - m).max() for d, m in
               zip(out["denoised"], out["mixed_processed"])) > 1e-2
    # bench.py's keys less vs_baseline, plus the card
    assert (set(line) | set(bench.CARD_KEYS)
            == set(root_line) - {"vs_baseline"} | set(bench.CARD_KEYS))
    assert not set(line) & set(bench.CARD_KEYS)
    assert line["metric"] == root_line["metric"] == "denoise_rtf_per_chip"
    assert line["value"] > 0

    # the suite's segmented call, on segments of 0.5 s
    long = np.concatenate(mixed)
    enh = bench.make_enhancer(tcfg, args, "cpu", state)
    _, got = bench.timed_long(enh, long, pos[0], neg[0], segment_seconds=0.5)
    want = jenh.enhance_long(long, pos[0], neg[0], segment_seconds=0.5)
    _assert_waves(got, want, batch=False)


def test_suite_line_carries_bench_py_keys(narrow, root_runs, tree,
                                          monkeypatch):
    """The suite's line at narrow widths, its long call cut to 2 s on
    segments of 0.5 s."""
    _, root_line, args = root_runs["suite"]
    twins = {task: twin_configs(task, model=SMALL_MODEL)[1]
             for task in ("denoiser", "separator")}
    monkeypatch.setattr(bench, "serving_config",
                        lambda args, task, with_dtype=True: twins[task])
    monkeypatch.setattr(bench, "LONG_SECONDS", 2)
    monkeypatch.setattr(bench, "timed_long", functools.partial(
        bench.timed_long, segment_seconds=0.5, segment_batch=2))
    line = bench.bench_suite(args, "cpu")
    assert set(line) == set(root_line)
    assert list(line["configs"]) == list(root_line["configs"])
    assert all(v > 0 for v in line["configs"].values())
    assert line["value"] == min(line["configs"].values())


@pytest.mark.parametrize("run", ["train_streamed", "train_banked"])
def test_training_run_at_narrow_width(narrow, root_runs, run):
    """The harness's first loss equals the port's step on the same inputs,
    and its line carries bench.py's keys."""
    _, tcfg, _, _ = narrow
    _, root_line, args = root_runs[run]
    line, first = bench.bench_train(args, "cpu", cfg=tcfg)
    model, state, tx = create_state(tcfg, torch.Generator().manual_seed(0),
                                    "cpu")
    step = make_train_step(tcfg, model, tx, banked=args.banked)
    arrays = bench.train_inputs(args, tcfg)
    inputs = ([arrays["banks"], arrays["idx"]] if args.banked
              else [arrays["batch"]])
    want = step(state, *[{k: torch.from_numpy(v) for k, v in a.items()}
                         for a in inputs],
                torch.Generator().manual_seed(1))["loss"].item()
    assert first == want
    assert np.isfinite(first)
    assert set(line) | set(bench.CARD_KEYS) == set(root_line) | set(
        bench.CARD_KEYS)
    assert line["windows_per_step"] == args.train_utts * 2
    assert line["flops_per_step"] > 0 and line["mfu_est"] is not None


def _analytic_flops(model, run):
    """2 x the multiply-adds of every Conv and Dense call in ``run()``,
    from the shapes of their weights and outputs: the modules' calls, and
    the main tower's convolutions that the inference forward hands to
    ``ops.tower_conv`` instead."""
    from nhans_tpu_torch.nn import model as nn_model

    total = [0]

    def conv(mod, inputs, y):
        o, i, kh, kw = mod.w.shape
        total[0] += 2 * y.shape[0] * o * y.shape[2] * y.shape[3] * i * kh * kw

    def dense(mod, inputs, y):
        n_in, n_out = mod.w.shape
        total[0] += 2 * (inputs[0].numel() // n_in) * n_in * n_out

    real = nn_model.tower_conv

    def tower_conv(x, w, *args):
        y = real(x, w, *args)
        total[0] += 2 * y.numel() * w[0].numel()
        return y

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv) else dense)
             for m in model.modules() if isinstance(m, (Conv, Dense))]
    nn_model.tower_conv = tower_conv
    try:
        run()
    finally:
        nn_model.tower_conv = real
        for h in hooks:
            h.remove()
    return total[0]


def test_flop_count_is_the_analytic_count(narrow):
    _, tcfg, _, _ = narrow
    m = tcfg.model
    model = build_model(tcfg).eval()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, m.window_frames, m.num_features, generator=g)
    ctx = torch.randn(5, m.context_frames, m.num_features, generator=g)

    def forward():
        with torch.no_grad():
            model(x, ctx, ctx)

    counted = bench.count_flops(forward)
    assert counted == _analytic_flops(model, forward) > 0


def test_command_refuses_without_a_card():
    r = subprocess.run([sys.executable, "-m", "nhans_tpu_torch.bench"],
                       cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "measures the card" in r.stderr
