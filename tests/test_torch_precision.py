"""The port's compute dtype (``ModelConfig.compute_dtype="bfloat16"``)
against the JAX package in bfloat16 on the CPU, at reduced widths, from
the same parameters (tests/test_torch_train_step.py's seeded variables).

bfloat16 keeps 8 significant bits, so one rounding that falls the other
way (another summation order, a tiny change of an input) moves a value by
up to 2^-8 of it, and a train step carries such flips through every
layer: a relative change of 1e-6 in the parameters moves the port's own
bfloat16 step by 3.7e-4 in loss, 0.9 % in gradient norm and 9 % in its
updates, more than the JAX package's bfloat16 step lies from its float32
step in gradient norm. The step's bars are therefore set from that
spread, and what tells bfloat16 from float32 apart is checked where the
rounding does not mix: the inference forward (the JAX package's float32
forward lies 3.3e-3 of the output's largest magnitude from its bfloat16
one) and the dtypes that reach each convolution and matmul.

Bars:
- inference forward and context embeddings: max |diff| below 1e-3 of the
  reference's largest magnitude, and the JAX float32 forward at least
  2e-3 from the JAX bfloat16 one, so the bar tells them apart;
- train step: loss within 2e-3 relative, gradient norm within 0.1
  relative, the updates (all but the biases that feed a BatchNorm, whose
  exact gradient is zero) within 0.3 of their norm, and the first
  BatchNorm's new statistics within 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nhans_tpu.data.pipeline import make_train_batch as j_make_train_batch
from nhans_tpu.models import build_model as j_build_model
from nhans_tpu.nn.model import freq_weighted_mse as j_freq_weighted_mse
from nhans_tpu_torch.compat.weights import to_flax
from nhans_tpu_torch.nn.blocks import BatchNorm
from nhans_tpu_torch.train.step import make_train_step, make_tx, state_of
from tests.make_torch_golden import jax_train_draws, twin_configs
from tests.test_torch_train_step import (B, K, L, SMALL_MODEL, _batch, _flat,
                                         _nest, _port, _torch, _variables)

FWD_BAR = 1e-3
FWD_GAP = 2e-3
LOSS_RTOL = 2e-3
GNORM_RTOL = 0.1
UPDATE_RTOL = 0.3
FIRST_BN_ATOL = 1e-6
# biases whose exact gradient is zero (a BatchNorm takes the shift out)
NOISE = ("conv2/b", "transform/b", "proj_a/b", "proj_b/b")
FIRST_BN = "batch_stats/embedding/block1/bn1/"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _configs(dtype, alg="sgd"):
    return twin_configs("denoiser", model=dict(SMALL_MODEL,
                                               compute_dtype=dtype),
                        data=dict(max_samples=L, slices_per_step=K),
                        train=dict(alg=alg, lr=1e-2))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's batch, inference forward and train step (sgd, lr
    1e-2: loss, gradient norm, new parameters and statistics) in float32
    and in bfloat16 from the same variables."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, _ = _configs(dtype)
        flat, batch, key = _variables(jcfg), _batch(), jax.random.PRNGKey(5)
        ex = j_make_train_batch(jcfg, key, *(jnp.asarray(batch[k]) for k in (
            "clean", "noise_a", "noise_b", "clean_len", "len_a", "len_b")),
            peaks=jnp.asarray(batch["peaks"]), stft_impl="xla")
        model = j_build_model(jcfg)
        params = _nest({k[7:]: v for k, v in flat.items()
                        if k.startswith("params/")})
        stats = _nest({k[12:]: v for k, v in flat.items()
                       if k.startswith("batch_stats/")})
        W = jcfg.model.window_frames

        def loss_fn(p):
            res, mut = model.apply({"params": p, "batch_stats": stats},
                                   ex["mixed"], ex["ctx_a"], ex["ctx_b"],
                                   True, mutable=["batch_stats"])
            loss, _ = j_freq_weighted_mse(ex["mixed"][:, W // 2, :] + res,
                                          ex["target"])
            return loss, mut["batch_stats"]

        (loss, new_stats), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        inference = model.apply({"params": params, "batch_stats": stats},
                                ex["mixed"], ex["ctx_a"], ex["ctx_b"], False)
        gflat = _flat(grads, "params")
        out[dtype] = dict(
            jcfg=jcfg, flat=flat, batch=batch, key=key,
            ex={k: np.array(v) for k, v in ex.items()},
            inference=np.asarray(inference, np.float32), loss=float(loss),
            grad_norm=float(optax.global_norm(grads)),
            params={k: flat[k] - 1e-2 * gflat[k] for k in gflat},
            stats=_flat(new_stats, "batch_stats"))
    return out


def _updates(params, flat):
    return np.concatenate([(params[k] - flat[k]).ravel()
                           for k in sorted(params) if not k.endswith(NOISE)])


def test_inference_forward_in_bfloat16_matches_jax(jax_steps):
    ref = jax_steps["bfloat16"]
    _, tcfg = _configs("bfloat16")
    model = _port(tcfg, ref["flat"])
    with torch.no_grad():
        got = model(*(torch.from_numpy(ref["ex"][k])
                      for k in ("mixed", "ctx_a", "ctx_b")))
    assert got.dtype == torch.float32
    assert _err(got.numpy(), ref["inference"]) < FWD_BAR
    assert _err(jax_steps["float32"]["inference"], ref["inference"]) > FWD_GAP


def test_train_step_in_bfloat16_matches_jax(jax_steps):
    ref = jax_steps["bfloat16"]
    jcfg, tcfg = _configs("bfloat16")
    model = _port(tcfg, ref["flat"])
    tx = make_tx(tcfg)
    state = state_of(model, tx)
    m = make_train_step(tcfg, model, tx)(
        state, _torch(ref["batch"]), None,
        draws=_torch(jax_train_draws(jcfg, ref["key"], B, K)))
    np.testing.assert_allclose(float(m["loss"]), ref["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), ref["grad_norm"],
                               rtol=GNORM_RTOL)
    params = to_flax(dict(model.named_parameters()), "params")
    want = _updates(ref["params"], ref["flat"])
    got = _updates(params, ref["flat"])
    assert np.linalg.norm(got - want) <= UPDATE_RTOL * np.linalg.norm(want)
    stats = to_flax(dict(model.named_buffers()), "batch_stats")
    for name in ("pop_mean", "pop_variance"):
        np.testing.assert_allclose(stats[FIRST_BN + name],
                                   ref["stats"][FIRST_BN + name],
                                   atol=FIRST_BN_ATOL, rtol=0)


def test_bfloat16_casts_where_flax_does(jax_steps):
    """Every convolution and matmul of a bfloat16 train step takes
    bfloat16 operands; BatchNorm moments and statistics, parameters,
    gradients, the residual and the loss stay float32."""
    ref = jax_steps["bfloat16"]
    jcfg, tcfg = _configs("bfloat16", alg="adam")
    model = _port(tcfg, ref["flat"])
    seen = {"conv2d": set(), "matmul": set(), "moments": set(),
            "residual": set()}
    inside = []  # the model's forward is running (the batch's DFT is not)

    class Record(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if not inside:
                pass
            elif func is torch.nn.functional.conv2d:
                seen["conv2d"].update(a.dtype for a in args[:3]
                                      if isinstance(a, torch.Tensor))
            elif func is torch.matmul:
                seen["matmul"].update(a.dtype for a in args)
            return func(*args, **(kwargs or {}))

    def moments(module, inputs, output):
        if module.training:
            seen["moments"].add(module.pop_mean.dtype)

    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            bn.register_forward_hook(moments)
    model.register_forward_pre_hook(lambda m, i: inside.append(1))

    def residual(module, inputs, output):
        inside.clear()
        seen["residual"].add(output.dtype)

    model.register_forward_hook(residual)
    tx = make_tx(tcfg)
    state = state_of(model, tx)
    with Record():
        m = make_train_step(tcfg, model, tx)(
            state, _torch(ref["batch"]), None,
            draws=_torch(jax_train_draws(jcfg, ref["key"], B, K)))
    assert seen["conv2d"] == {torch.bfloat16}
    assert seen["matmul"] == {torch.bfloat16}
    assert seen["moments"] == {torch.float32}
    assert seen["residual"] == {torch.float32}
    assert m["loss"].dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    assert {t.dtype for k in ("mu", "nu")
            for t in state.opt_state[k].values()} == {torch.float32}
    # a bfloat16 checkpoint is a float32 one: it serves in float32
    _, f32 = _configs("float32")
    served = _port(f32, {**to_flax(dict(model.named_parameters()), "params"),
                         **to_flax(dict(model.named_buffers()),
                                   "batch_stats")})
    assert next(served.parameters()).dtype == torch.float32


def test_bfloat16_context_embedding_is_bfloat16(jax_steps):
    """The context tower's pooled embedding is in the compute dtype, as
    jnp.mean of a bfloat16 tensor gives it (a float32 sum, rounded)."""
    ref = jax_steps["bfloat16"]
    _, tcfg = _configs("bfloat16")
    model = _port(tcfg, ref["flat"])
    with torch.no_grad():
        ea, eb = model(None, torch.from_numpy(ref["ex"]["ctx_a"]),
                       torch.from_numpy(ref["ex"]["ctx_b"]))
    assert ea.dtype == eb.dtype == torch.bfloat16
    jm = j_build_model(ref["jcfg"])
    variables = {"params": _nest({k[7:]: v for k, v in ref["flat"].items()
                                  if k.startswith("params/")}),
                 "batch_stats": _nest({k[12:]: v
                                       for k, v in ref["flat"].items()
                                       if k.startswith("batch_stats/")})}
    ja, _ = jm.apply(variables, None, ref["ex"]["ctx_a"], ref["ex"]["ctx_b"],
                     False)
    assert ja.dtype == jnp.bfloat16
    assert _err(ea.float().numpy(), np.asarray(ja, np.float32)) < FWD_BAR
