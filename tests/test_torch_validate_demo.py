"""The port's ``tools/validate_demo`` against the JAX package's
``tools/validate_demo.py``: the separator-context derivation and the
example finder (with its exact kind-token match) give equal results, and
both tools' records on a synthetic corpus in the ``DEMO_N-HANS`` layout,
with no checkpoint (each package's random initialisation, whose residual
is 0), agree within 1e-3 dB (SI-SDR) and 1e-4 (STOI)."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from nhans_tpu_torch.tools import validate_demo
from tests.make_torch_golden import write_demo_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_validate_demo", os.path.join(REPO, "tools", "validate_demo.py"))
j_validate_demo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(j_validate_demo)

DB_ATOL = 1e-3
STOI_ATOL = 1e-4


def _signals(seconds=1.6, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    clean = 6000 * np.sin(2 * np.pi * (180 + 30 * np.sin(3 * t)) * t)
    noise = rng.standard_normal(len(t)) * 1500
    other = 4000 * np.sin(2 * np.pi * 310 * t) * (1 + 0.5 * np.sin(5 * t))
    return clean, noise, other


@pytest.mark.parametrize("mode", ["head2s", "residual_full"])
def test_derive_separator_contexts_equals_jax(mode):
    clean, noise, other = _signals(seconds=5.3)
    mixed, golden = clean + other, clean + 0.1 * noise
    got = validate_demo.derive_separator_contexts(mixed, golden, mode=mode)
    want = j_validate_demo.derive_separator_contexts(mixed, golden, mode=mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_find_examples_equals_jax(tmp_path):
    x = np.zeros(1600, np.int16)
    layout = {
        "denoising/ex_a": ("mixed", "denoised", "target", "negNoise",
                           "posNoise"),
        "selective_noise_suppression/ex_b": ("mixed", "denoised", "noise"),
        # "noise" is a substring of "denoised": the golden output must not
        # become the interference context
        "source_separation/ex_c": ("mixed", "separated"),
        "source_separation/ex_d": ("mixed",),
    }
    for sub, kinds in layout.items():
        os.makedirs(tmp_path / sub)
        for kind in kinds:
            wavfile.write(str(tmp_path / sub / f"clip_{kind}.wav"), 16000, x)
    (tmp_path / "source_separation" / "README").write_text("not a dir")
    for task in ("denoiser", "selective", "separator"):
        got = validate_demo.find_examples(str(tmp_path), task)
        assert got == j_validate_demo.find_examples(str(tmp_path), task)
        assert len(got) == 1
    sep, = validate_demo.find_examples(str(tmp_path), "separator")
    assert sep["neg"] is None and sep["pos"] is None
    assert validate_demo.find_examples(str(tmp_path / "absent"), "denoiser") \
        == []


@pytest.mark.parametrize("task", ["denoiser", "separator"])
def test_records_agree_with_jax(tmp_path, monkeypatch, capsys, task):
    write_demo_tree(str(tmp_path / "demo"), *_signals())
    flags = ["--demo_root", str(tmp_path / "demo"), "--task", task]
    got = validate_demo.main([*flags, "--device", "cpu", "--ac", "--json",
                              str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == pytest.approx(got)
    monkeypatch.setattr(sys, "argv", ["validate_demo", *flags, "--ac",
                                      "--json", str(tmp_path / "jax.json")])
    j_validate_demo.main()
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert "example1" in capsys.readouterr().out
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    if task == "denoiser":
        assert {"si_sdr_ours", "stoi_ours", "si_sdr_ours_ac"} <= set(got[0])
    for key, value in want[0].items():
        if key == "example":
            assert got[0][key] == value
            continue
        bar = STOI_ATOL if key.startswith("stoi") else DB_ATOL
        if key.startswith("pesq"):
            bar = 1e-3
        assert abs(got[0][key] - value) <= bar, (key, got[0][key], value)
