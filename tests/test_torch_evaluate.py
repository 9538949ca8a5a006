"""The port's Evaluator (device="cpu") against the JAX package's on the
same examples and weights, with a reduced model (9-frame windows,
20-frame contexts, narrow channels) on 1 and 2.5 s buckets: the denoiser
and the separator, the amplification cap on and off, three utterances in
groups of two (a ragged last group, padded by repeating its example).

Tolerances: the same metric keys; eval_loss within 1e-5 relative; SI-SDR
within 1e-3 dB; STOI and ESTOI within 1e-4; PESQ within 1e-3; every
reconstruction within 1e-4; each utterance's per-window losses within
1e-4 of their largest.  The wav dump names and the dump_results files
are the same sets.

make_eval_batch of both packages: log-magnitudes and phases within 1e-4
(1e-2 at the fewer than 0.1 % of bins whose magnitude is at most 1e-2,
where the JAX package's float32 DFT rounding, about 2e-7, exceeds 1e-4
of |X|), the masks and counts equal; the port's spectrograms are taken in
float64 as in tests/test_torch_pipeline.py.  The Evaluator tests keep
the port's float32 spectrogram."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from nhans_tpu.data.pipeline import make_eval_batch as j_make_eval_batch
from nhans_tpu.models import build_model as j_build_model
from nhans_tpu.models import init_variables as j_init_variables
from nhans_tpu.train.evaluate import Evaluator as JEvaluator
from nhans_tpu_torch.data.pipeline import make_eval_batch
from nhans_tpu_torch.models import build_model
from nhans_tpu_torch.train.checkpoint import load_into
from nhans_tpu_torch.train.evaluate import Evaluator
from tests.make_torch_golden import twin_configs
from tests.test_torch_pipeline import float64_spectrogram  # noqa: F401

SMALL_MODEL = dict(
    window_frames=9, context_frames=20, embedding_dim=16,
    pos_embed_hidden=8,
    main_blocks=((3, 1, 8), (3, 2, 16)),
    context_blocks=(((4, 4), (2, 2), 8), ((3, 3), (1, 2), 16)))
KW = dict(eval_batch=2, buckets_seconds=(1.0, 2.5), window_chunk=64)
ZERO_INIT = ("proj_a/w", "proj_b/w", "dense3/w", "last_dense/w", "/beta")
METRIC_TOL = {"eval_loss": ("rel", 1e-5), "si_sdr": ("abs", 1e-3),
              "si_sdr_mixed": ("abs", 1e-3), "si_sdr_gain": ("abs", 1e-3),
              "si_sdr_interferer": ("abs", 1e-3),
              "confused_utts": ("abs", 0), "stoi": ("abs", 1e-4),
              "stoi_mixed": ("abs", 1e-4), "estoi": ("abs", 1e-4),
              "estoi_mixed": ("abs", 1e-4), "pesq": ("abs", 1e-3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The model is tiny: one intra-op thread runs it faster than a pool
    that contends for the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(jcfg, seed=0):
    """Flat flax variables of the reduced model: the flax init, the
    zero-initialised layers and the BatchNorm betas seeded, and the
    head's bias raised at the lowest 12 bins so that the residuals there
    exceed the 2-nat amplification cap."""
    _, v = j_init_variables(jcfg, jax.random.PRNGKey(seed), train=False)
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, x in flatten_dict(jax.device_get(v[coll])).items():
            flat[f"{coll}/" + "/".join(k)] = np.array(x, np.float32)
    rng = np.random.default_rng(seed + 100)
    for k in sorted(flat):
        if k.endswith(ZERO_INIT):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.05
                       ).astype(np.float32)
    flat["params/last_dense/b"][:12] += 3.0
    return flat


def _nest(flat):
    tree = {}
    for key, x in flat.items():
        d = tree
        parts = key.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(x)
    return tree


def _examples(task, seed=3):
    """Three examples as EvalLoader yields them: 1.7, 0.9 and 2.3 s of a
    tone in noise, noises shorter and longer than the utterance."""
    rng = np.random.default_rng(seed)
    two = task == "denoiser"
    out = []
    for i, sec in enumerate((1.7, 0.9, 2.3)):
        n = int(sec * 16000)
        t = np.arange(n) / 16000
        clean = (6000 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                 + rng.standard_normal(n) * 500)
        na = rng.standard_normal(int((0.7 + i) * 16000)) * 2000
        nb = rng.standard_normal(41600) * 3000 if two else np.zeros(1)
        ex = {"clean": np.rint(clean).astype(np.float32),
              "noise_a": np.rint(na).astype(np.float32),
              "noise_b": np.rint(nb).astype(np.float32),
              "clean_len": n, "len_a": len(na), "len_b": len(nb) if two else 0,
              "snr_a": (-5, 0, 5)[i], "snr_b": (0, 5, -5)[i] if two else 0,
              "cleanpath": f"/c/spk{i}_u{i}.wav", "path_a": f"/n/a{i}.wav",
              "path_b": f"/n/b{i}.wav" if two else ""}
        ex["peaks"] = np.asarray(
            [np.abs(ex[k]).max() if ex[k].size else 0.0
             for k in ("clean", "noise_a", "noise_b")], np.float32)
        if not two:
            ex["peaks"][2] = 0.0
        out.append(ex)
    return out


def _run(package, task, cap, tmp_path):
    """(metrics, wav dump names, dump_results directory) of one package's
    Evaluator on the examples."""
    jcfg, tcfg = twin_configs(task, model=SMALL_MODEL,
                              audio=dict(recon_residual_cap=cap))
    flat = _variables(jcfg)
    if package == "jax":
        evaluator = JEvaluator(jcfg, j_build_model(jcfg), **KW)
        variables = _nest(flat)
    else:
        model = build_model(tcfg)
        load_into(model, flat)
        evaluator, variables = Evaluator(tcfg, model, **KW), None
    wavs, dump = tmp_path / f"{package}_wav", tmp_path / f"{package}_dump"
    metrics = evaluator.run(variables, _examples(task), step=7,
                            modelname="m", wav_dump_folder=str(wavs),
                            dump_results=str(dump), return_metrics=True)
    return metrics, sorted(os.listdir(wavs)), str(dump)


@pytest.mark.parametrize("cap", [2.0, 0.0])
@pytest.mark.parametrize("task", ["denoiser", "separator"])
def test_evaluator_matches_jax(task, cap, tmp_path):
    want, jwavs, jdump = _run("jax", task, cap, tmp_path)
    got, twavs, tdump = _run("port", task, cap, tmp_path)
    assert set(got) == set(want)
    if task == "separator":
        assert "si_sdr_interferer" in got and "confused_utts" in got
    assert "stoi" in got and "pesq" in got
    for name, value in want.items():
        kind, tol = METRIC_TOL[name]
        bar = tol * abs(value) if kind == "rel" else tol
        assert abs(got[name] - value) <= bar, (name, got[name], value)
    # names of the reconstructions: 3 utterances x 5 kinds (denoiser) or
    # x 3 (separator, noise_b "none")
    assert twavs == jwavs
    assert len(jwavs) == 3 * (5 if task == "denoiser" else 3)
    assert sorted(os.listdir(tdump)) == sorted(os.listdir(jdump))
    for f in sorted(os.listdir(jdump)):
        w, g = np.load(os.path.join(jdump, f)), np.load(os.path.join(tdump, f))
        assert g.shape == w.shape, f
        if "_loss_" in f:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f)
    if task == "denoiser":
        # the rigged head makes the cap bite: the output differs with and
        # without it, and only in the reconstruction
        den = np.load(os.path.join(tdump, "m_eval_7_denoised_0.npy"))
        other = _run("port", task, 2.0 - cap, tmp_path / "other")
        den2 = np.load(os.path.join(other[2], "m_eval_7_denoised_0.npy"))
        assert np.abs(den - den2).max() > 1e-2
        assert other[0]["eval_loss"] == got["eval_loss"]


@pytest.mark.parametrize("W, C", [(35, 200), (9, 20)])
def test_make_eval_batch_matches_jax(W, C, float64_spectrogram):  # noqa: F811
    jcfg, tcfg = twin_configs(
        "denoiser", model=dict(window_frames=W, context_frames=C))
    L = 400 + 160 * 260                       # 261 frames
    rng = np.random.default_rng(5)
    sigs = [(rng.standard_normal((1, L)) * scale).astype(np.float32)
            for scale in (0.3, 0.25, 0.2, 0.1)]
    n = np.array([L - 3000], np.int32)        # 242 whole frames
    want = j_make_eval_batch(jcfg, *[jnp.asarray(s) for s in sigs],
                             jnp.asarray(n))
    got = make_eval_batch(tcfg, *[torch.from_numpy(s) for s in sigs],
                          torch.from_numpy(n).long())
    assert set(got) == set(want)
    assert got["mixed"].shape == (1, 261 - C, W, 201)
    assert int(got["num_windows"][0]) == 242 - C
    # bins where the exact magnitude is at most 1e-2: there the JAX
    # package's float32 DFT rounding (about 2e-7) is above 1e-4 of |X|
    small = {k: np.exp(got[k].numpy()) <= 1e-2
             for k in ("mixed", "mixed_lm", "target", "ctx_a", "ctx_b")}
    small["mixed_ph"] = small["mixed_lm"]
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        if k in small:
            tiny = small[k]
            assert tiny.mean() < 1e-3, (k, int(tiny.sum()))
            d = (np.angle(np.exp(1j * (g - w))) if k == "mixed_ph"
                 else g - w)
            np.testing.assert_allclose(d[~tiny], 0, atol=1e-4, err_msg=k)
            np.testing.assert_allclose(d[tiny], 0, atol=1e-2, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
