"""The lane-padded main tower (``ModelConfig.freq_pad_to``) against the
native geometry and against the JAX package's padded tower, on the CPU.

- Inference: the padded tower's output equals the native tower's under
  the same weights (the JAX package pins the same in
  tests/test_model_oracle.py::test_freq_pad_inference_bit_compatible):
  within 1e-5 of the output's largest magnitude at full width with the
  shipped denoiser (the two geometries convolve tensors of other widths,
  so float32 sums may run in another order).
- Training (reduced widths): the training forward's residual and every
  BatchNorm's new statistics (whose moments now include the dead
  columns), and one sgd step, against the JAX package's padded model at
  the bars of tests/test_torch_train_step.py (loss and gradient norm
  1e-5 relative, parameters and statistics 1e-5 + 1e-4 relative).
- Serving: ``NHANS_FREQ_PAD=256`` through the denoiser command line
  against the JAX ``Enhancer`` built with ``freq_pad_to=256``, at the
  bars of tests/test_torch_cli.py (wavs 1e-4, snr_est 1e-4 relative).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from nhans_tpu.config import Config as JConfig
from nhans_tpu.data.pipeline import make_train_batch as j_make_train_batch
from nhans_tpu.infer.enhance import Enhancer as JEnhancer
from nhans_tpu.models import build_model as j_build_model
from nhans_tpu.nn.model import freq_weighted_mse as j_freq_weighted_mse
from nhans_tpu.utils import wavio as jwavio
from nhans_tpu_torch.compat.weights import load_npz, to_flax
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.nn.model import NHANSNet
from nhans_tpu_torch.train.step import make_train_step, make_tx, state_of
from tests.make_torch_golden import (DENOISER_NPZ, jax_train_draws,
                                     jax_variables, twin_configs)
from tests.test_torch_train_step import (ATOL, B, K, L, RTOL, RTOL_SCALAR,
                                         SMALL_MODEL, _batch, _compare_state,
                                         _nest, _port, _torch, _variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD = 256
INFER_RTOL = 1e-5
WAVE_ATOL = 1e-4
SNR_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_padded_inference_equals_native_geometry(rng):
    base = Config.denoiser().model
    native = NHANSNet(base)
    padded = NHANSNet(dataclasses.replace(base, freq_pad_to=PAD))
    weights = load_npz(DENOISER_NPZ)
    native.load_state_dict(weights)
    padded.load_state_dict(weights)  # the same parameter shapes and names
    mixed = torch.from_numpy(
        (rng.standard_normal((3, 35, 201)) * 2.0 - 4.0).astype(np.float32))
    ctx = torch.from_numpy(
        (rng.standard_normal((3, 200, 201)) * 2.0 - 6.0).astype(np.float32))
    with torch.no_grad():
        want = native(mixed, ctx, ctx.flip(1))
        got = padded(mixed, ctx, ctx.flip(1))
    assert padded.resblock1.freq_valid == 201
    assert padded.resblock8.freq_out == native.freq_out == 26
    assert got.shape == want.shape == (3, 201)
    scale = float(want.abs().max())
    assert scale > 1e-2  # the shipped head is not the zero map
    assert float((got - want).abs().max()) <= INFER_RTOL * scale


@pytest.fixture(scope="module")
def padded_configs():
    model = dict(SMALL_MODEL, freq_pad_to=PAD)
    return twin_configs("denoiser", model=model,
                        data=dict(max_samples=L, slices_per_step=K),
                        train=dict(alg="sgd", lr=1e-2))


def test_padded_training_forward_and_step_match_jax(padded_configs):
    jcfg, tcfg = padded_configs
    flat, key, batch = _variables(jcfg, seed=4), jax.random.PRNGKey(11), \
        _batch(seed=8)
    ex = j_make_train_batch(jcfg, key, *(jnp.asarray(batch[k]) for k in (
        "clean", "noise_a", "noise_b", "clean_len", "len_a", "len_b")),
        peaks=jnp.asarray(batch["peaks"]), stft_impl="xla")
    jmodel = j_build_model(jcfg)
    params = _nest({k[7:]: v for k, v in flat.items()
                    if k.startswith("params/")})
    stats = _nest({k[12:]: v for k, v in flat.items()
                   if k.startswith("batch_stats/")})
    W = jcfg.model.window_frames

    def loss_fn(p):
        res, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                ex["mixed"], ex["ctx_a"], ex["ctx_b"], True,
                                mutable=["batch_stats"])
        loss, _ = j_freq_weighted_mse(ex["mixed"][:, W // 2, :] + res,
                                      ex["target"])
        return loss, (mut["batch_stats"], res)

    (loss, (new_stats, res)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    # the training forward: residual and statistics
    model = _port(tcfg, flat).train()
    got = model(*(torch.from_numpy(np.array(ex[k]))
                  for k in ("mixed", "ctx_a", "ctx_b")))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(res),
                               atol=ATOL, rtol=RTOL)
    _compare_state(model, params, new_stats)

    # one sgd step
    model = _port(tcfg, flat)
    tx = make_tx(tcfg)
    state = state_of(model, tx)
    m = make_train_step(tcfg, model, tx)(
        state, _torch(batch), None,
        draws=_torch(jax_train_draws(jcfg, key, B, K)))
    np.testing.assert_allclose(float(m["loss"]), float(loss),
                               rtol=RTOL_SCALAR)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(optax.global_norm(grads)),
                               rtol=RTOL_SCALAR)
    updates = jax.tree_util.tree_map(lambda g: -1e-2 * g, grads)
    _compare_state(model, optax.apply_updates(params, updates), new_stats)
    # the padded tower trains statistics of its own: the dead columns
    # enter the moments
    native = _port(dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, freq_pad_to=0)),
        flat).train()
    native(*(torch.from_numpy(np.array(ex[k]))
             for k in ("mixed", "ctx_a", "ctx_b")))
    padded_stats = to_flax(dict(model.named_buffers()), "s")
    native_stats = to_flax(dict(native.named_buffers()), "s")
    key_bn = "s/resblock1/bn1/pop_mean"
    assert not np.allclose(padded_stats[key_bn], native_stats[key_bn],
                           atol=1e-4)


def _write(path, samples):
    wavfile.write(str(path), 16000, np.rint(samples).astype(np.int16))


def test_cli_serves_padded_tower_as_jax_enhancer(tmp_path):
    rng = np.random.default_rng(21)
    t = np.arange(8000) / 16000.0
    _write(tmp_path / "in.wav", 5000 * np.sin(2 * np.pi * 230 * t)
           + rng.standard_normal(len(t)) * 1500)
    _write(tmp_path / "neg.wav", rng.standard_normal(40000) * 1500)
    out = tmp_path / "out.wav"
    r = subprocess.run(
        [sys.executable, "-m", "nhans_tpu_torch.cli.denoiser", "--device",
         "cpu", "--checkpoint", DENOISER_NPZ, "--input",
         str(tmp_path / "in.wav"), "--neg", str(tmp_path / "neg.wav"),
         "--output", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, NHANS_FREQ_PAD=str(PAD)))
    assert r.returncode == 0, r.stderr
    fs = 16000
    x, neg = (jwavio.read_for_processing(str(tmp_path / n), fs)
              for n in ("in.wav", "neg.wav"))
    cfg = JConfig.denoiser()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, freq_pad_to=PAD))
    ref = JEnhancer(cfg, jax_variables(DENOISER_NPZ),
                    out_wire="float32").enhance(x, np.zeros(fs), neg)
    for fname, key in (("out.wav", "denoised"),
                       ("out_mixed_processed.wav", "mixed_processed"),
                       ("out_removed.wav", "removed")):
        rate, got = wavfile.read(str(tmp_path / fname))
        assert rate == fs and got.dtype == np.float32
        np.testing.assert_allclose(got, ref[key].astype(np.float32),
                                   atol=WAVE_ATOL, err_msg=fname)
    snr = float(next(line for line in r.stdout.splitlines()
                     if line and "->" not in line
                     and not line.startswith("NOTE")))
    np.testing.assert_allclose(snr, float(ref["snr_est"]), rtol=SNR_RTOL)
