"""Whole runs of each driver on the CPU at a narrow size: the port against
the reference, the result line's keys, the control's separation, and
faults planted under the timed path that the comparison has to catch.

The narrow model has random weights of a larger scale than the trained
ones, whose sgd updates round more in float32; so the training limits
here are the narrow model's own, set from its sound readings (loss 1e-6,
gradients 1e-3, changes 8e-3 over three sgd steps)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests import narrow

RUN_PY = os.path.join(harness.HERE, "run.py")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
EDITS = {"denoiser.folder": narrow.small_folder,
         "denoiser.interactive": narrow.small_interactive,
         "separator.train_sgd": narrow.small_train,
         "separator.train_adam": narrow.small_train}
NARROW_TRAIN = {"first_loss_gap": 1e-5, "loss_gap": 1e-4, "grad_gap": 1e-2,
                "change_gap": 5e-2, "median_change_gap": 2e-2}


def _runmod():
    spec = importlib.util.spec_from_file_location("bench_run", RUN_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cell, tmp, steps=None, seed=1):
    def edit(w):
        EDITS[cell](w)
        if "steps" in w["check"]:
            w["check"]["limits"] = dict(NARROW_TRAIN)
            w["check"]["steps"] = steps or w["check"]["steps"]
    r = narrow.run(cell, tmp, seed=seed, workload_edits=edit,
                   max_samples=0 if cell.startswith("denoiser") else 48000)
    return r, harness.load_module("drivers", r.workload["driver"])


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(EDITS))
def test_sound_run_is_correct_with_the_contract_keys(cell, tmp_path):
    r, driver = _run(cell, str(tmp_path), steps=1 if "adam" in cell else 3)
    result = _runmod().execute(r, driver, 0.0)
    assert list(result) == KEYS
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in r.metrics("end_to_end")}
    assert set(result["metrics"]) == names
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}


def test_serving_port_agrees_with_the_reference_tightly(tmp_path):
    r, driver = _run("denoiser.folder", str(tmp_path))
    state = driver.setup(r)
    driver.window(state, 0.0)
    checks = {c["name"]: c["value"] for c in driver.check(state)}
    assert checks["wav_gap"] < 1e-5 and checks["snr_gap"] < 1e-5


@pytest.mark.parametrize("alg", ["sgd", "adam"])
def test_one_training_step_agrees_with_the_reference(alg, tmp_path):
    r, driver = _run(f"separator.train_{alg}", str(tmp_path), steps=1)
    state = driver.setup(r)
    driver.window(state, 0.0)
    checks = {c["name"]: c["value"] for c in driver.check(state)}
    assert checks["loss_gap"] < 1e-5
    assert checks["grad_gap"] < 5e-3
    # Adam's first update is lr * g / (|g| + 1e-8): elements whose gradient
    # is near 1e-8 move by round-off, more of them in the narrow model
    assert checks["change_gap"] < (5e-3 if alg == "sgd" else 5e-2)


def test_serving_control_reads_far_above_the_program(tmp_path):
    """The TF32 reference in the program's place reads at least 3x what
    the program reads, here as on the card."""
    from benchmark import serving
    from benchmark.control import serving_control

    r, driver = _run("denoiser.folder", str(tmp_path))
    state = driver.setup(r)
    driver.window(state, 0.0)
    sample = serving.sample(r, state["done"])
    program = {c["name"]: c["value"] for c in driver.check(state)}
    control = serving_control(r, sample)
    assert control["wav_gap"] > 3 * program["wav_gap"]
    assert control["wav_gap"] > r.workload["check"]["limits"]["wav_gap"]


@pytest.mark.parametrize("alg", ["sgd", "adam"])
def test_training_control_and_fault_read_above_the_program(alg, tmp_path):
    """The TF32 reference and half the batch, each in the program's place,
    read above what the program reads, here as on the card."""
    from benchmark.control import training_readings

    r, driver = _run(f"separator.train_{alg}", str(tmp_path), steps=1)
    state = driver.setup(r)
    out = training_readings(r, state, program=True, controls=True,
                            witness=True)
    assert out["tf32"]["first_loss_gap"] > 3 * out["program"]["first_loss_gap"]
    assert out["tf32"]["first_loss_gap"] > NARROW_TRAIN["first_loss_gap"] / 10
    assert out["half_batch"]["grad_gap"] > NARROW_TRAIN["grad_gap"]
    # float32's rounding alone, against float64, reads as the program does
    witness = out["float32_vs_float64"]
    assert witness["first_loss_gap"] < NARROW_TRAIN["first_loss_gap"]
    assert witness["grad_gap"] < NARROW_TRAIN["grad_gap"]
    assert isinstance(witness["grad_leaf"], str)
    assert isinstance(out["program_vs_float64"]["change_leaf"], str)


def _fault_run(cell, tmp, monkeypatch, plant, steps=None):
    r, driver = _run(cell, tmp, steps=steps)
    plant(monkeypatch)
    return _runmod().execute(r, driver, 0.0)


def test_an_answer_altered_where_it_is_produced_fails(tmp_path, monkeypatch):
    from nhans_tpu_torch.infer import enhance

    def plant(mp):
        real = enhance.Enhancer._materialize.__func__

        def altered(cls, outs, nreal):
            out = real(cls, outs, nreal)
            out["denoised"] = [d * 1.01 for d in out["denoised"]]
            return out
        mp.setattr(enhance.Enhancer, "_materialize", classmethod(altered))

    for cell in ("denoiser.folder", "denoiser.interactive"):
        assert not _fault_run(cell, str(tmp_path), monkeypatch,
                              plant)["correct"]


@pytest.mark.parametrize("alg", ["sgd", "adam"])
def test_a_step_that_leaves_the_state_unchanged_fails(alg, tmp_path,
                                                      monkeypatch):
    from nhans_tpu_torch.train import step as step_mod

    def plant(mp):
        real = step_mod.make_tx

        def frozen(cfg):
            tx = real(cfg)
            return tx._replace(update=lambda g, s: (
                {k: torch.zeros_like(v) for k, v in g.items()},
                tx.update(g, s)[1]))
        mp.setattr(step_mod, "make_tx", frozen)

    result = _fault_run(f"separator.train_{alg}", str(tmp_path), monkeypatch,
                        plant, steps=1)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] > 0.5


def test_an_adam_update_uniformly_off_fails(tmp_path, monkeypatch):
    """Every update 30 % too large: the median leaf's change catches it,
    where no single leaf stands out."""
    from nhans_tpu_torch.train import step as step_mod

    def plant(mp):
        real = step_mod.make_tx

        def scaled(cfg):
            tx = real(cfg)

            def update(g, s):
                u, s2 = tx.update(g, s)
                return {k: 1.3 * v for k, v in u.items()}, s2
            return tx._replace(update=update)
        mp.setattr(step_mod, "make_tx", scaled)

    result = _fault_run("separator.train_adam", str(tmp_path), monkeypatch,
                        plant)
    assert not result["correct"]
    assert result["checks"]["median_change_gap"]["value"] > 0.2


@pytest.mark.parametrize("alg", ["sgd", "adam"])
def test_half_the_batch_left_out_fails(alg, tmp_path, monkeypatch):
    from nhans_tpu_torch.train import step as step_mod

    def plant(mp):
        real = step_mod.make_train_batch

        def half(*a, **k):
            ex = real(*a, **k)
            return {key: v[:v.shape[0] // 2] for key, v in ex.items()}
        mp.setattr(step_mod, "make_train_batch", half)

    result = _fault_run(f"separator.train_{alg}", str(tmp_path), monkeypatch,
                        plant, steps=1)
    assert not result["correct"]


def test_reference_imports_nothing_of_the_program():
    import ast

    ref = os.path.join(harness.HERE, "reference")
    for name in sorted(os.listdir(ref)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] not in harness.FORBIDDEN + (
                    "nhans_tpu_torch",), (name, m)


def test_quantile_traffic_is_the_same_work_for_every_seed():
    from benchmark import traffic

    lengths = traffic.quantile_lengths(64, 4.0, 0.6, 1.0, 20.0, 16000)
    seqs = []
    for seed in (1, 2 ** 33 + 5):
        rng = np.random.default_rng([seed, 0])
        batches = traffic.name_order_batches(rng, 64, 8, 10)
        assert sorted(i for b in batches for i in b) == list(range(64))
        seqs.append([sorted(b) for b in batches])
    assert seqs[0] == seqs[1]


def test_the_folder_deal_pads_as_the_median_name_order():
    """The folder cell's fixed name order pads its batches to the median
    of what the command line's batches of random name orders pad to."""
    from benchmark import serving, traffic

    run = harness.open_run("denoiser.folder", 1, 1.0, False, device="cpu")
    tp = run.workload["traffic_params"]
    lengths = traffic.quantile_lengths(
        tp["files"], sample_rate=run.config["sample_rate"], **tp["length_s"])

    def padded(batches):
        return sum(len(b) * serving.bucket(run, lengths[b]) for b in batches)

    rng = np.random.default_rng(0)
    named = [padded(traffic.name_order_batches(rng, tp["files"], tp["batch"],
                                               s)) for s in range(2001)]
    mine = padded(traffic.name_order_batches(rng, tp["files"], tp["batch"],
                                             tp["deal_seed"]))
    assert mine == np.median(named)
