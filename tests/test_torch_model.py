"""The port's layers and model against the flax modules of nhans_tpu on the
same parameters.  Layers and the reduced model: every leaf random, even
the zero-initialised projections and head (at init the model is the
identity and would hide bugs).  Full width: both shipped checkpoints.
Bar for the models: the oracle bar err.max() / (|ref|.max() + 1) < 2e-4
of tests/test_model_oracle.py; layers: atol 1e-5 (float32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhans_tpu.config import Config as JConfig
from nhans_tpu.models import init_variables
from nhans_tpu.nn import blocks as jblocks
from nhans_tpu.nn.model import NHANSNet as JNet
from nhans_tpu_torch.compat.weights import from_flax, load_npz
from nhans_tpu_torch.config import Config, ModelConfig
from nhans_tpu_torch.models import build_model
from nhans_tpu_torch.nn import blocks
from nhans_tpu_torch.nn.model import NHANSNet
from tests.make_torch_golden import DENOISER_NPZ, SEPARATOR_NPZ, jax_variables

ORACLE_BAR = 2e-4


def _oracle_err(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1.0)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _randomize(flat, rng):
    out = {}
    for k, v in flat.items():
        r = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        if k.endswith(("pop_variance", "gamma")):
            r = np.abs(r) + 0.5
        out[k] = r
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


@pytest.mark.parametrize("kernel,strides,padding,hw", [
    ((8, 4), (3, 2), "SAME", (200, 201)),
    ((4, 4), (2, 2), "SAME", (35, 201)),
    ((3, 3), (2, 2), "SAME", (9, 51)),
    ((4, 4), (1, 2), "SAME", (23, 51)),
    ((1, 1), (2, 2), "SAME", (35, 201)),
    ((5, 1), (1, 1), "VALID", (5, 26)),
])
def test_conv_matches_flax(rng, kernel, strides, padding, hw):
    cin, cout = 3, 5
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)      # NHWC
    w = rng.standard_normal((*kernel, cin, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = jblocks.Conv(cout, kernel, strides, padding=padding).apply(
        {"params": {"w": w, "b": b}}, jnp.asarray(x))
    conv = blocks.Conv(cin, cout, kernel, strides, padding=padding)
    conv.load_state_dict({"w": torch.from_numpy(w.transpose(3, 2, 0, 1)),
                          "b": torch.from_numpy(b)})
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_dense_and_batchnorm_match_flax(rng):
    x = rng.standard_normal((4, 7, 6, 12)).astype(np.float32)
    w = rng.standard_normal((12, 9)).astype(np.float32)
    b = rng.standard_normal(9).astype(np.float32)
    ref = jblocks.Dense(9).apply({"params": {"w": w, "b": b}}, jnp.asarray(x))
    dense = blocks.Dense(12, 9)
    dense.load_state_dict({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    with torch.no_grad():
        got = dense(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)

    c = 12
    v = {"params": {"beta": rng.standard_normal(c).astype(np.float32),
                    "gamma": rng.standard_normal(c).astype(np.float32)},
         "batch_stats": {
             "pop_mean": rng.standard_normal(c).astype(np.float32),
             "pop_variance": (rng.random(c) + 0.1).astype(np.float32)}}
    ref = jblocks.BatchNorm().apply(v, jnp.asarray(x), False)
    bn = blocks.BatchNorm(c)
    bn.load_state_dict({k: torch.from_numpy(a) for coll in v.values()
                        for k, a in coll.items()})
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_same_pads_puts_odd_pad_high():
    assert blocks.same_pads(200, 8, 3) == (3, 3, 67)
    assert blocks.same_pads(201, 4, 3) == (0, 1, 67)
    assert blocks.same_pads(201, 4, 2) == (1, 2, 101)
    assert blocks.same_pads(35, 1, 2) == (0, 0, 18)


_SMALL = dict(context_frames=40, embedding_dim=12, pos_embed_hidden=10,
              main_blocks=((4, 1, 8), (3, 2, 16)),
              context_blocks=(((8, 4), (3, 2), 8), ((4, 4), (1, 2), 16)))


def test_reduced_model_matches_flax_with_every_leaf_random(rng):
    jcfg = JConfig.denoiser()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **_SMALL))
    jmodel, variables = init_variables(jcfg, jax.random.PRNGKey(1),
                                       train=False)
    flat = _randomize(_flatten(jax.device_get(variables)), rng)
    model = NHANSNet(ModelConfig(**_SMALL))
    model.load_state_dict(from_flax(flat), strict=True)
    model.eval()

    mixed = rng.standard_normal((3, 35, 201)).astype(np.float32)
    ca = rng.standard_normal((3, 40, 201)).astype(np.float32)
    cb = rng.standard_normal((3, 40, 201)).astype(np.float32)
    jv = _unflatten(flat)
    ref = np.asarray(jmodel.apply(jv, mixed, ca, cb, False))
    ea, eb = jmodel.apply(jv, None, ca, cb, False)
    t = [torch.from_numpy(a) for a in (mixed, ca, cb)]
    with torch.no_grad():
        got = model(*t).numpy()
        ga, gb = model(None, t[1], t[2])
        got_emb = model(t[0], emb_a=ga, emb_b=gb).numpy()
        frames = model.enhance_frames(*t).numpy()
    assert got.shape == ref.shape == (3, 201)
    assert np.abs(ref).max() > 1e-2  # the head is not the zero map
    assert _oracle_err(got, ref) < ORACLE_BAR
    assert _oracle_err(ga.numpy(), np.asarray(ea)) < ORACLE_BAR
    assert _oracle_err(gb.numpy(), np.asarray(eb)) < ORACLE_BAR
    np.testing.assert_allclose(got_emb, got, atol=1e-6)
    np.testing.assert_allclose(frames, mixed[:, 17] + got, atol=1e-6)


def test_residual_with_strided_identity_is_refused():
    with pytest.raises(ValueError):
        NHANSNet(ModelConfig(**dict(_SMALL, main_blocks=((4, 1, 8),
                                                         (3, 2, 8)))))


@pytest.mark.parametrize("npz", [DENOISER_NPZ, SEPARATOR_NPZ])
def test_full_width_matches_flax_on_shipped_weights(rng, npz):
    mixed = (rng.standard_normal((8, 35, 201)) * 2.0 - 4.0).astype(np.float32)
    ca = (rng.standard_normal((2, 200, 201)) * 2.0 - 6.0).astype(np.float32)
    cb = (rng.standard_normal((2, 200, 201)) * 2.0 - 5.0).astype(np.float32)
    jmodel = JNet(JConfig.denoiser().model)
    jv = jax_variables(npz)
    ea, eb = jmodel.apply(jv, None, ca, cb, False)
    ea = np.repeat(np.asarray(ea), 4, axis=0)
    eb = np.repeat(np.asarray(eb), 4, axis=0)
    ref = np.asarray(jmodel.apply(jv, mixed, None, None, False,
                                  emb_a=ea, emb_b=eb))
    model = build_model(Config.denoiser())
    model.load_state_dict(load_npz(npz), strict=True)
    model.eval()
    with torch.no_grad():
        ga, gb = model(None, torch.from_numpy(ca), torch.from_numpy(cb))
        got = model(torch.from_numpy(mixed), emb_a=ga.repeat_interleave(4, 0),
                    emb_b=gb.repeat_interleave(4, 0)).numpy()
    assert _oracle_err(ga.numpy(), np.asarray(ea[::4])) < ORACLE_BAR
    assert _oracle_err(got, ref) < ORACLE_BAR
