"""Model preparation in the port: ``cli.load_denoiser``/``load_separator``
(a TF bundle converted, or a fresh init written), the checkpoint forms
the serving ``--checkpoint`` takes, and serving and scoring a random
initialisation, against the JAX package on the CPU.

The TF bundles are the shipped weights (docs/quality/*_q5_swa.npz) under
their TF names, with biases and BatchNorm tensors [1, 1, 1, C]
(``tests/make_torch_golden.py::write_tf_bundle``): the conversion must
give back every tensor exactly.  The random init's ``last_dense`` is
zero in both packages, so its served output depends on no draw: the
port's seeded init is held to the JAX ``PRNGKey(0)`` output
(tests/data/torch_golden_random_init.npz) within 1e-4, the bar of
tests/test_torch_cli.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from nhans_tpu_torch.cli import evaluate as cli_evaluate
from nhans_tpu_torch.cli._app import RANDOM_INIT_WARNING, load_weights
from nhans_tpu_torch.cli.load_model import main_separator
from nhans_tpu_torch.compat.weights import load_npz
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.infer.enhance import Enhancer
from nhans_tpu_torch.models import build_model, random_init_state
from nhans_tpu_torch.compat import orbax
from nhans_tpu_torch.compat.weights import from_flax
from nhans_tpu_torch.train.checkpoint import (TRAIN_STATE, VARIABLES,
                                              Checkpointer, load_into,
                                              load_variables, save_variables)
from nhans_tpu_torch.train.step import TrainState
from tests.make_torch_golden import (DENOISER_NPZ, GOLDEN, GOLDEN_RANDOM_INIT,
                                     JAX_SNR_RTOL, JAX_WAVE_ATOL,
                                     SEPARATOR_NPZ, golden_inputs,
                                     input_digest, jax_random_init_golden,
                                     random_init_inputs, write_tf_bundle)
from tests.test_torch_eval_cli import CUTS, _corpus, _printed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE_ATOL = 1e-4
SNR_RTOL = 1e-4
NPZ = {"denoiser": DENOISER_NPZ, "separator": SEPARATOR_NPZ}


def _module(name, *args):
    return subprocess.run([sys.executable, "-m", name, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("task", ["denoiser", "separator"])
def test_load_model_converts_a_tf_bundle_exactly(tmp_path, task):
    prefix = str(tmp_path / "trained_model" / "81448_0-1000000")
    os.makedirs(os.path.dirname(prefix))
    write_tf_bundle(NPZ[task], task, prefix)
    out = tmp_path / f"{task}_ckpt"
    r = _module(f"nhans_tpu_torch.cli.load_{task}", "--tf_checkpoint",
                prefix, "--output", str(out))
    assert r.returncode == 0, r.stderr
    assert "converted TF checkpoint" in r.stdout
    # the Orbax variables directory the JAX command writes
    assert sorted(os.listdir(out)) == ["_CHECKPOINT_METADATA", "_METADATA",
                                       "d", "manifest.ocdbt"]
    got, want = orbax.read(str(out)), _npz(NPZ[task])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], value.astype(np.float32))
    # it loads on a model, and into serving, as the .npz does
    cfg = getattr(Config, task)()
    load_into(build_model(cfg), got)
    state, ref = load_weights(cfg, str(out)), load_npz(NPZ[task])
    assert all(torch.equal(state[k], ref[k]) for k in ref)


def test_converted_checkpoint_serves_the_golden_output(tmp_path):
    """The converted denoiser, through the serving loader, reproduces the
    JAX package's golden output (tests/test_torch_golden.py's bar)."""
    prefix = str(tmp_path / "ck")
    write_tf_bundle(DENOISER_NPZ, "denoiser", prefix)
    out = str(tmp_path / "den")
    r = _module("nhans_tpu_torch.cli.load_denoiser", "--tf_checkpoint",
                prefix, "--output", out)
    assert r.returncode == 0, r.stderr
    cfg = Config.denoiser()
    got = Enhancer(cfg, load_weights(cfg, out), device="cpu").enhance(
        *golden_inputs())
    gold = _npz(GOLDEN)
    for key in ("denoised", "mixed_processed"):
        np.testing.assert_allclose(got[key], gold[key], atol=WAVE_ATOL)
    np.testing.assert_allclose(got["snr_est"], gold["snr_est"],
                               rtol=SNR_RTOL)


def test_load_model_without_a_bundle_writes_the_seeded_init(tmp_path,
                                                             capsys):
    out = main_separator(["--output", str(tmp_path / "fresh")])
    assert "WARNING: no --tf_checkpoint given" in capsys.readouterr().err
    cfg = Config.separator()
    state, want = load_weights(cfg, out), random_init_state(cfg)
    assert sorted(state) == sorted(want)
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert float(state["last_dense.w"].abs().max()) == 0.0
    assert float(state["resblock1.conv1.w"].abs().max()) > 0.0


def test_bad_bundle_is_a_message(tmp_path):
    r = _module("nhans_tpu_torch.cli.load_denoiser", "--tf_checkpoint",
                str(tmp_path / "absent"), "--output", str(tmp_path / "o"))
    assert r.returncode != 0
    assert "error:" in r.stderr and "Traceback" not in r.stderr
    assert not os.path.exists(tmp_path / "o")


def _step_tree(root, flat, orbax_steps):
    """A trainer's layout, steps 2 and 5, the latest holding ``flat``:
    Orbax steps as the port's trainer writes them (an sgd state), or the
    ``<root>/nhans/<step>/{variables,train_state}.npz`` of earlier
    versions of the port."""
    for step, values in ((2, {k: v * 0 for k, v in flat.items()}),
                         (5, flat)):
        if orbax_steps:
            state = from_flax(values)
            stats = {k for k in state if k.endswith("pop_mean")
                     or k.endswith("pop_variance")}
            Checkpointer(root).save(step, TrainState(
                step=step,
                params={k: v for k, v in state.items() if k not in stats},
                batch_stats={k: state[k] for k in stats},
                opt_state={"count": step}))
            continue
        d = os.path.join(root, "nhans", str(step))
        os.makedirs(d)
        np.savez(os.path.join(d, VARIABLES), **values)
        np.savez(os.path.join(d, TRAIN_STATE), step=np.int64(step))
    os.makedirs(os.path.join(root, "nhans", "7.tmp-1"))  # half written
    return os.path.join(root, "nhans", "5")


def test_checkpoint_forms_give_the_same_weights(tmp_path):
    """Every form ``--checkpoint`` takes, the Orbax forms the port writes
    and the ``.npz`` forms of its earlier versions, serves the shipped
    weights exactly."""
    flat = {k: v.astype(np.float32) for k, v in _npz(DENOISER_NPZ).items()}
    forms = [DENOISER_NPZ]
    for tag, orbax_steps in (("ck", True), ("ck_npz", False)):
        root = tmp_path / tag
        forms += [_step_tree(str(root), flat, orbax_steps), str(root),
                  str(root / "nhans")]
    forms.append(save_variables(str(tmp_path / "vars"), flat))
    vdir = tmp_path / "vars_npz"
    vdir.mkdir()
    np.savez(vdir / VARIABLES, **flat)
    forms.append(str(vdir))
    cfg = Config.denoiser()
    want = load_npz(DENOISER_NPZ)
    for form in forms:
        state = load_weights(cfg, form)
        assert all(torch.equal(state[k], want[k]) for k in want), form
    assert sorted(load_variables(str(tmp_path / "vars"))) == sorted(flat)


def test_orbax_directory_is_refused_with_the_pack_route(tmp_path):
    """An Orbax directory of the JAX package was refused with its
    ``tools/ckpt_npz.py pack`` route; now the serving command line serves
    it.  The run root of a JAX ``Checkpointer`` holding the shipped weights
    in an sgd train state (as the JAX trainer saves) serves the same wavs
    as the ``.npz``, without the pack route's message."""
    import jax.numpy as jnp

    from nhans_tpu.train.checkpoint import Checkpointer
    from nhans_tpu.train.optim import make_optimizer
    from nhans_tpu.train.step import TrainState
    from tests.make_torch_golden import jax_variables

    variables = jax_variables(DENOISER_NPZ)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(7, TrainState(
        step=jnp.int32(7), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=make_optimizer("sgd", 1e-3).init(variables["params"])))
    ck.wait()
    ck.close()
    mixed, _, neg = _wavs(tmp_path)
    procs = {}
    for tag, checkpoint in (("orbax", str(tmp_path / "ck")),
                            ("npz", DENOISER_NPZ)):
        (tmp_path / tag).mkdir()
        procs[tag] = subprocess.Popen(
            [sys.executable, "-m", "nhans_tpu_torch.cli.denoiser", "--device",
             "cpu", "--checkpoint", checkpoint, "--input", mixed, "--neg", neg,
             "--pos", "", "--output", str(tmp_path / tag / "out.wav")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    for tag, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err
        assert "ckpt_npz.py pack" not in err
    names = sorted(os.listdir(tmp_path / "npz"))
    assert len(names) == 4 and sorted(os.listdir(tmp_path / "orbax")) == names
    for name in names:
        assert np.array_equal(_read(str(tmp_path / "orbax" / name)),
                              _read(str(tmp_path / "npz" / name))), name


def _wavs(tmp_path):
    paths = []
    for name, x in zip(("mixed", "pos", "neg"), random_init_inputs()):
        paths.append(str(tmp_path / f"{name}.wav"))
        wavfile.write(paths[-1], 16000, x)
    return paths


def _read(path):
    rate, x = wavfile.read(path)
    assert rate == 16000 and x.dtype == np.float32
    return x


def test_jax_package_reproduces_random_init_golden():
    gold, got = _npz(GOLDEN_RANDOM_INIT), jax_random_init_golden()
    assert str(gold["input_sha256"]) == input_digest(
        *(x.astype(np.float64) for x in random_init_inputs()))
    for key, value in gold.items():
        if key.endswith("snr_est"):
            np.testing.assert_allclose(got[key], value, rtol=JAX_SNR_RTOL)
        elif key != "input_sha256":
            np.testing.assert_allclose(got[key], value, atol=JAX_WAVE_ATOL)


@pytest.mark.parametrize("task", ["denoiser", "separator"])
def test_random_init_serving_matches_jax(tmp_path, task):
    mixed, pos, neg = _wavs(tmp_path)
    out = str(tmp_path / "out.wav")
    r = _module(f"nhans_tpu_torch.cli.{task}", "--device", "cpu", "--input",
                mixed, "--pos", pos, "--neg", neg, "--output", out)
    assert r.returncode == 0, r.stderr
    assert RANDOM_INIT_WARNING in r.stderr
    gold = _npz(GOLDEN_RANDOM_INIT)
    for tag, key in (("", f"{task}/denoised"),
                     ("_mixed_processed", "mixed_processed"),
                     ("_removed", f"{task}/removed")):
        got = _read(out.replace(".wav", f"{tag}.wav"))
        assert got.shape == gold[key].shape
        np.testing.assert_allclose(got, gold[key], atol=WAVE_ATOL)
    if task == "denoiser":
        snr = float(r.stdout.splitlines()[0])
        np.testing.assert_allclose(snr, gold["denoiser/snr_est"],
                                   rtol=SNR_RTOL)


def test_random_init_evaluation_matches_jax(tmp_path, capsys, monkeypatch):
    """``cli.evaluate`` with no checkpoint against the JAX command's
    ``PRNGKey(0)`` evaluation, same corpus and flags."""
    from nhans_tpu.cli import evaluate as j_evaluate

    speech, noise = _corpus(tmp_path)
    flags = ["--speech_wav_dir", speech, "--noise_wav_dir", noise,
             "--wav_dump_folder", "", "--dump_results", "", *CUTS]
    got = cli_evaluate.main(["--device", "cpu", *flags])
    captured = capsys.readouterr()
    assert RANDOM_INIT_WARNING in captured.err
    monkeypatch.setattr(sys, "argv", ["nhans_evaluate", *flags])
    j_evaluate.main()
    want = _printed(capsys.readouterr().out, got)
    assert set(want) == set(got)
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-4 * max(1.0, abs(value)), (
            key, got[key], value)
