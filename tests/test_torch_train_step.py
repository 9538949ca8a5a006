"""The port's training forward and train step (nhans_tpu_torch/nn,
models/, train/step.py) against the JAX package on the CPU, at reduced
widths, from the same flax-initialised parameters carried across by
nhans_tpu_torch/compat/weights.py.

The flax init zeroes the Inject projections, the positional MLPs' last
layers and last_dense, so a first step from it moves last_dense alone;
here those layers get seeded values first, so that one step reaches every
parameter.  Every BatchNorm beta gets a seeded offset too: at beta = 0 the
positional MLPs' first BatchNorm puts the centre position (their inputs
are 0..n-1, n odd) exactly on the ReLU's kink, where the gradient is a
matter of rounding in either framework.

Adam's first update is -lr * g / (|g| + 1e-8): +-lr wherever |g| is well
above 1e-8, whatever its size.  Where g is rounding noise it takes the
noise's sign; so it does for every bias that feeds a BatchNorm (conv2/b,
transform/b, the Inject projections' b), whose gradient is exactly zero in
exact arithmetic because the BatchNorm takes a per-channel shift out
again, and both frameworks compute noise of about 1e-6 for it.  For Adam
an element whose update on either side is below 0.9999 lr (|g| below
about 1e-4) is held to |update| <= lr on both sides, and the rest to the
bars below.

Tolerances: loss and global gradient norm within 1e-5 relative; new
parameters and BatchNorm population statistics within 1e-5 absolute +
1e-4 relative (float32 convolutions summed in another order, and
optimizer steps that rescale gradients of about 1e-3); a BatchNorm
forward within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from nhans_tpu.data.pipeline import make_train_batch as j_make_train_batch
from nhans_tpu.models import build_model as j_build_model
from nhans_tpu.models import init_variables as j_init_variables
from nhans_tpu.nn.blocks import BatchNorm as JBatchNorm
from nhans_tpu.nn.model import freq_weighted_mse as j_freq_weighted_mse
from nhans_tpu.train.optim import make_optimizer as j_make_optimizer
from nhans_tpu.train.step import TrainState as JTrainState
from nhans_tpu.train.step import make_train_step as j_make_train_step
from nhans_tpu_torch.compat.weights import to_flax
from nhans_tpu_torch.models import build_model, init_variables
from nhans_tpu_torch.nn.blocks import BatchNorm
from nhans_tpu_torch.train.checkpoint import load_into
from nhans_tpu_torch.train.step import (make_train_step, make_tx,
                                        param_counts, state_of)
from tests.make_torch_golden import jax_train_draws, twin_configs

RTOL_SCALAR = 1e-5
ATOL, RTOL = 1e-5, 1e-4

SMALL_MODEL = dict(
    window_frames=9, context_frames=20, embedding_dim=16,
    pos_embed_hidden=8,
    main_blocks=((3, 1, 8), (3, 2, 16)),
    context_blocks=(((4, 4), (2, 2), 8), ((3, 3), (1, 2), 16)))
L = 400 + 160 * 40
B, K = 2, 2
ZERO_INIT = ("proj_a/w", "proj_b/w", "dense3/w", "last_dense/w")
SEEDED = ZERO_INIT + ("/beta",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    a pool that contends for the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix):
    return {f"{prefix}/" + "/".join(k): np.asarray(v, np.float32)
            for k, v in flatten_dict(jax.device_get(tree)).items()}


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        d = tree
        parts = key.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(v)
    return tree


def _variables(jcfg, seed=0):
    """Flat flax variables of the reduced model, the zero-initialised
    layers and the BatchNorm betas given seeded values."""
    _, v = j_init_variables(jcfg, jax.random.PRNGKey(seed), train=True)
    flat = {**_flat(v["params"], "params"),
            **_flat(v["batch_stats"], "batch_stats")}
    rng = np.random.default_rng(seed + 100)
    for k in sorted(flat):
        if k.endswith(SEEDED):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.05
                       ).astype(np.float32)
    return flat


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    clean = np.stack([7000 * np.sin(2 * np.pi * (160 + 90 * b) * t)
                      + rng.standard_normal(L) * 900 for b in range(B)])
    batch = {
        "clean": np.rint(clean).astype(np.int16),
        "noise_a": np.rint(rng.standard_normal((B, L)) * 2000).astype(np.int16),
        "noise_b": np.rint(rng.standard_normal((B, L + 700)) * 3000
                           ).astype(np.int16),
        "clean_len": np.array([L, L - 1234], np.int32),
        "len_a": np.array([L - 500, L], np.int32),
        "len_b": np.array([L + 700, 2600], np.int32),
    }
    batch["peaks"] = np.stack(
        [np.abs(batch[k]).max(1) for k in ("clean", "noise_a", "noise_b")],
        axis=1).astype(np.float32)
    return batch


def _port(tcfg, flat):
    model = build_model(tcfg)
    load_into(model, flat)
    return model


def _compare_state(model, jparams, jstats, adam_lr=None, before=None):
    """New params and batch stats against flax's; with ``adam_lr``, the
    elements whose update is noise-driven (see the module docstring) are
    held to |update| <= lr on both sides."""
    want = {**_flat(jparams, "params"), **_flat(jstats, "batch_stats")}
    got = {**to_flax(dict(model.named_parameters()), "params"),
           **to_flax(dict(model.named_buffers()), "batch_stats")}
    assert set(got) == set(want)
    for k in sorted(want):
        g, w = got[k], want[k]
        if adam_lr is not None and k.startswith("params/"):
            dg, dw = np.abs(g - before[k]), np.abs(w - before[k])
            noise = (dg < 0.9999 * adam_lr) | (dw < 0.9999 * adam_lr)
            bound = adam_lr * (1 + 1e-4)
            assert dg.max() <= bound and dw.max() <= bound, k
            g, w = g[~noise], w[~noise]
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=k)


def _jax_banked_step(jcfg, flat, banks, idx, key):
    """The JAX package's banked make_train_step from ``flat``."""
    jmodel = j_build_model(jcfg)
    t = jcfg.train
    tx = j_make_optimizer(t.alg, t.lr, t.mom)
    params = _nest({k[7:]: v for k, v in flat.items()
                    if k.startswith("params/")})
    stats = _nest({k[12:]: v for k, v in flat.items()
                   if k.startswith("batch_stats/")})
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=stats, opt_state=tx.init(params))
    step = j_make_train_step(jcfg, jmodel, tx, donate=False, banked=True)
    new, m = step(state, {k: jnp.asarray(v) for k, v in banks.items()},
                  {k: jnp.asarray(v) for k, v in idx.items()}, key)
    return new, {k: float(v) for k, v in m.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX side of one denoiser step from ``_variables``: the batch of
    nhans_tpu.data.pipeline.make_train_batch, then make_train_step's loss
    (the frequency-weighted MSE), its gradient and the new BatchNorm
    statistics, taken once; each optimizer case applies its optax update
    to these gradients, as make_train_step does."""
    jcfg, _ = twin_configs("denoiser", model=SMALL_MODEL,
                           data=dict(max_samples=L, slices_per_step=K))
    flat, batch, key = _variables(jcfg), _batch(), jax.random.PRNGKey(5)
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
        return loss, mut["batch_stats"]

    (loss, new_stats), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return dict(flat=flat, batch=batch, key=key, params=params,
                grads=grads, new_stats=new_stats, loss=float(loss),
                grad_norm=float(optax.global_norm(grads)))


@pytest.mark.parametrize("alg", ["sgd", "momentum", "rmsprop", "adadelta",
                                 "adagrad", "adam"])
def test_one_step_matches_jax(alg, jax_reference):
    ref = jax_reference
    mom = 0.9 if alg == "momentum" else 0.0
    jcfg, tcfg = twin_configs(
        "denoiser", model=SMALL_MODEL,
        data=dict(max_samples=L, slices_per_step=K),
        train=dict(alg=alg, lr=1e-3, mom=mom))
    tx = j_make_optimizer(alg, 1e-3, mom)
    updates, _ = tx.update(ref["grads"], tx.init(ref["params"]),
                           ref["params"])
    jparams = optax.apply_updates(ref["params"], updates)

    flat = ref["flat"]
    model = _port(tcfg, flat)
    ttx = make_tx(tcfg)
    state = state_of(model, ttx)
    step = make_train_step(tcfg, model, ttx)
    m = step(state, _torch(ref["batch"]), None,
             draws=_torch(jax_train_draws(jcfg, ref["key"], B, K)))
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), ref["loss"],
                               rtol=RTOL_SCALAR)
    np.testing.assert_allclose(float(m["grad_norm"]), ref["grad_norm"],
                               rtol=RTOL_SCALAR)
    _compare_state(model, jparams, ref["new_stats"],
                   adam_lr=1e-3 if alg == "adam" else None, before=flat)
    # the step moved every parameter group it reaches
    moved = to_flax(dict(model.named_parameters()), "params")
    assert not np.allclose(moved["params/resblock1/conv1/w"],
                           flat["params/resblock1/conv1/w"])


@pytest.mark.parametrize("task,boost", [("separator", 0.0),
                                        ("denoiser", 2.0)])
def test_banked_step_and_clean_loss_boost_match_jax(task, boost):
    """Against the JAX package's whole make_train_step: the banked step
    gathers rows of the device banks by index; with clean_loss_boost the
    near-clean windows are upweighted."""
    jcfg, tcfg = twin_configs(
        task, model=SMALL_MODEL, data=dict(max_samples=L, slices_per_step=K),
        train=dict(alg="sgd", lr=1e-2, clean_loss_boost=boost))
    flat, key = _variables(jcfg, seed=1), jax.random.PRNGKey(9)
    raw = _batch(seed=4)
    n = L + 700
    pad = lambda x: np.pad(x, ((0, 0), (0, n - x.shape[1])))  # noqa: E731
    banks = {"speech": pad(np.concatenate([raw["clean"], raw["noise_a"]])),
             "speech_len": np.concatenate([raw["clean_len"],
                                           raw["len_a"]]),
             "speech_peak": np.concatenate([raw["peaks"][:, 0],
                                            raw["peaks"][:, 1]]),
             "noise": np.concatenate([pad(raw["noise_a"]), raw["noise_b"]]),
             "noise_len": np.concatenate([raw["len_a"], raw["len_b"]]),
             "noise_peak": np.concatenate([raw["peaks"][:, 1],
                                           raw["peaks"][:, 2]])}
    idx = {"clean_idx": np.array([1, 0], np.int32),
           "a_idx": np.array([3, 2], np.int32),
           "b_idx": np.array([0, 3], np.int32)}
    jnew, jm = _jax_banked_step(jcfg, flat, banks, idx, key)

    model = _port(tcfg, flat)
    tx = make_tx(tcfg)
    state = state_of(model, tx)
    step = make_train_step(tcfg, model, tx, banked=True)
    m = step(state, _torch(banks), _torch(idx), None,
             draws=_torch(jax_train_draws(jcfg, key, B, K)))
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=RTOL_SCALAR)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=RTOL_SCALAR)
    _compare_state(model, jnew.params, jnew.batch_stats)


def test_training_forward_and_batch_stats_match_flax():
    """model.train(): the residual and every BatchNorm's new population
    statistics, the shared context encoder's moved twice (ctx_a's
    moments, then ctx_b's), as flax's mutable apply gives them."""
    jcfg, tcfg = twin_configs("denoiser", model=SMALL_MODEL,
                              data=dict(max_samples=L, slices_per_step=K))
    flat = _variables(jcfg, seed=2)
    key = jax.random.PRNGKey(1)
    batch = _batch(seed=6)
    ex = j_make_train_batch(jcfg, key, *(jnp.asarray(batch[k]) for k in (
        "clean", "noise_a", "noise_b", "clean_len", "len_a", "len_b")),
        peaks=jnp.asarray(batch["peaks"]), stft_impl="xla")
    jmodel = j_build_model(jcfg)
    variables = {
        "params": _nest({k[7:]: v for k, v in flat.items()
                         if k.startswith("params/")}),
        "batch_stats": _nest({k[12:]: v for k, v in flat.items()
                              if k.startswith("batch_stats/")})}
    res, mut = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, True, mutable=["batch_stats"]))(
            variables, ex["mixed"], ex["ctx_a"], ex["ctx_b"])

    model = _port(tcfg, flat).train()
    got = model(*(torch.from_numpy(np.array(ex[k]))
                  for k in ("mixed", "ctx_a", "ctx_b")))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(res),
                               atol=ATOL, rtol=RTOL)
    _compare_state(model, variables["params"], mut["batch_stats"])

    # the encoder's statistics moved twice: pop <- d (d pop + (1-d) m_a)
    # + (1-d) m_b, with the moments of each context's pass
    bn = model.embedding.block1.bn1
    conv = model.embedding.block1.conv1
    with torch.no_grad():
        moments = []
        for ctx in ("ctx_a", "ctx_b"):
            y = conv(torch.from_numpy(np.array(ex[ctx]))[:, None])
            moments.append((y.mean(dim=(0, 2, 3)),
                            (y * y).mean(dim=(0, 2, 3))
                            - y.mean(dim=(0, 2, 3)) ** 2))
    d = 0.95
    p0 = torch.from_numpy(
        flat["batch_stats/embedding/block1/bn1/pop_mean"].copy())
    want = d * (d * p0 + (1 - d) * moments[0][0]) + (1 - d) * moments[1][0]
    np.testing.assert_allclose(bn.pop_mean.numpy(), want.numpy(), atol=1e-6)


def test_batchnorm_training_forward_matches_flax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 6, 5, 3)) * 2 + 0.5).astype(np.float32)
    jbn = JBatchNorm(decay=0.95)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = {"params": {"beta": jnp.asarray(rng.standard_normal(3), jnp.float32),
                    "gamma": jnp.asarray(rng.standard_normal(3), jnp.float32)},
         "batch_stats": {"pop_mean": jnp.asarray([0.1, -0.2, 0.3]),
                         "pop_variance": jnp.asarray([1.5, 0.5, 2.0])}}
    y, mut = jbn.apply(v, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.beta.copy_(torch.tensor(np.asarray(v["params"]["beta"])))
        bn.gamma.copy_(torch.tensor(np.asarray(v["params"]["gamma"])))
        bn.pop_mean.copy_(torch.tensor([0.1, -0.2, 0.3]))
        bn.pop_variance.copy_(torch.tensor([1.5, 0.5, 2.0]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()  # NCHW
    out = bn.train()(xt)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), atol=1e-5)
    for name in ("pop_mean", "pop_variance"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mut["batch_stats"][name]),
                                   atol=1e-6, err_msg=name)
    # gradients flow through the batch moments: the output's sum over the
    # batch is beta-only, so d sum / dx is zero
    out.sum().backward()
    assert float(xt.grad.abs().max()) < 1e-4
    # inference uses the population statistics and moves nothing
    before = bn.pop_mean.clone()
    bn.eval()(xt.detach())
    assert torch.equal(bn.pop_mean, before)


def test_init_names_shapes_and_truncated_draws():
    jcfg, tcfg = twin_configs("denoiser")
    m = jcfg.model
    abstract = jax.eval_shape(
        lambda k: j_build_model(jcfg).init(
            k, jnp.zeros((1, m.window_frames, m.num_features)),
            jnp.zeros((1, m.context_frames, m.num_features)),
            jnp.zeros((1, m.context_frames, m.num_features)), train=True),
        jax.random.PRNGKey(0))
    want = {**{f"params/{'/'.join(k)}": v.shape for k, v in
               flatten_dict(abstract["params"]).items()},
            **{f"batch_stats/{'/'.join(k)}": v.shape for k, v in
               flatten_dict(abstract["batch_stats"]).items()}}
    g = torch.Generator()
    g.manual_seed(0)
    model = init_variables(tcfg, g, "cpu")
    got = {**to_flax(dict(model.named_parameters()), "params"),
           **to_flax(dict(model.named_buffers()), "batch_stats")}
    assert {k: v.shape for k, v in got.items()} == want

    std = tcfg.model.w_std
    # the standard deviation of N(0, 1) cut at +-2
    trunc_std = 0.8796256610342398
    w = got["params/resblock8/conv2/w"]
    assert np.abs(w).max() <= 2 * std
    np.testing.assert_allclose(w.std() / std, trunc_std, rtol=0.01)
    assert abs(w.mean()) < 0.01 * std
    for k, v in got.items():
        if k.endswith(ZERO_INIT):
            assert not v.any(), k
        elif k.endswith("/b") or k.endswith("/beta") or "pop_mean" in k:
            assert not v.any(), k
        elif k.endswith("/gamma") or "pop_variance" in k:
            assert (v == 1).all(), k
    trainable, non_trainable = param_counts(state_of(model, make_tx(tcfg)))
    assert trainable == sum(int(np.prod(v)) for k, v in want.items()
                            if k.startswith("params/"))
    assert non_trainable == sum(int(np.prod(v)) for k, v in want.items()
                                if k.startswith("batch_stats/"))
    # the same seed gives the same weights
    g.manual_seed(0)
    again = init_variables(tcfg, g, "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))


def test_ctx_embed_noise_statistics():
    """The jitter is e + sigma * RMS(e) * N(0, 1) per embedding, in
    training with a generator only."""
    _, tcfg = twin_configs("denoiser", model=dict(SMALL_MODEL,
                                                  ctx_embed_noise=0.5))
    g = torch.Generator()
    g.manual_seed(0)
    model = init_variables(tcfg, g, "cpu").train()
    rng = np.random.default_rng(0)
    ctx = torch.from_numpy(rng.standard_normal((64, 20, 201))
                           .astype(np.float32))
    with torch.no_grad():
        clean_a, clean_b = model(None, ctx, ctx.flip(0))
        noisy_a, noisy_b = model(None, ctx, ctx.flip(0), embed_noise=g)
        z = []
        for e, n in ((clean_a, noisy_a), (clean_b, noisy_b)):
            rms = torch.sqrt(torch.mean(e * e, dim=-1, keepdim=True) + 1e-8)
            z.append((n - e) / (0.5 * rms))
        z = torch.cat(z)
        assert abs(float(z.mean())) < 0.05
        assert abs(float(z.std()) - 1.0) < 0.05
        assert not torch.allclose(z[:64], z[64:])  # a and b draw apart
        a, b = model.eval()(None, ctx, ctx.flip(0), embed_noise=g)
        assert torch.equal(a, model(None, ctx, ctx.flip(0))[0])
