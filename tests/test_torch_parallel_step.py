"""The port's mesh step on several CPU processes (gloo, a ``file://``
store; ``tests/make_torch_golden.py::run_ranks``) against the JAX
package's mesh step on the conftest's 8-device CPU mesh, at reduced
widths, from the same weights (nhans_tpu_torch/parallel/, nn/blocks.py,
train/step.py).

* BatchNorm's training moments and their gradients on 2 ranks equal one
  process on the concatenated batch, and differ from per-rank moments.
* A 2-rank step, fed the JAX package's draws, equals
  ``make_train_step(mesh=make_mesh(data=2))``: loss 1e-5 relative, each
  update within 1e-4 of its tensor's largest |delta| plus one float32
  spacing of the tensor's values (the noise biases, whose exact gradient
  is zero, compared by nothing), statistics 1e-5 + 1e-4 relative; plain
  and banked with ``clean_loss_boost``.
* A 2-rank step whose draws and embedding jitter come from the step's
  generator equals the 1-rank step: each rank keeps its rows of the
  global draws; the ranks run it with ``remat``, which recomputes the
  main tower's blocks and their BatchNorms' all-reduces.
* ``model=2`` x ``data=2`` (4 ranks) equals ``data=2`` over two steps at
  the JAX package's bars for the same comparison
  (tests/test_sharding.py::test_model_axis_end_to_end: loss 1e-4
  relative, parameters 5e-5 absolute), with kernels held as halves.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhans_tpu.models import build_model as j_build_model
from nhans_tpu.parallel.mesh import make_mesh as j_make_mesh
from nhans_tpu.parallel.mesh import replicated_sharding
from nhans_tpu.parallel.mesh import shard_batch as j_shard_batch
from nhans_tpu.train.optim import make_optimizer as j_make_optimizer
from nhans_tpu.train.step import TrainState as JTrainState
from nhans_tpu.train.step import make_train_step as j_make_train_step
from nhans_tpu_torch.nn.blocks import BatchNorm
from nhans_tpu_torch.train.checkpoint import load_into
from nhans_tpu_torch.models import build_model
from nhans_tpu_torch.train.step import (make_train_step, make_tx, state_of,
                                        step_generator)
from tests.make_torch_golden import (NOISE_BIASES, jax_train_draws,
                                     run_ranks, twin_configs)
from tests.test_torch_train_step import (SMALL_MODEL, L, _batch, _flat,
                                         _nest, _variables)

RANKS_TIMEOUT = 110
LOSS_RTOL = 1e-5
DELTA_RTOL = 1e-4
STATS_ATOL, STATS_RTOL = 1e-5, 1e-4
K = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, world, name, **spec):
    """``rank_steps`` on ``world`` ranks; every rank's output."""
    spec["out"] = str(tmp_path / name)
    path = tmp_path / f"{name}.pkl"
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    run_ranks(world, "tests.make_torch_golden:rank_steps", str(path),
              timeout=RANKS_TIMEOUT, env={"OMP_NUM_THREADS": "1"})
    outs = []
    for r in range(world):
        with np.load(f"{spec['out']}.{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def rank_batchnorm(rank, world, x_path, out):
    """A rank of the BatchNorm check: its rows of the batch in ``x_path``
    through a training BatchNorm on the world's group; writes the output
    rows, the input's gradient and gamma's and beta's of the loss
    sum(y * w) over its rows, and the population statistics."""
    import torch.distributed as dist

    data = np.load(x_path)
    n = data["x"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    bn = BatchNorm(data["x"].shape[1]).train()
    bn.group = dist.group.WORLD
    x = torch.from_numpy(data["x"][rows]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(data["w"][rows])).sum().backward()
    np.savez(f"{out}.{rank}.npz", y=y.detach().numpy(),
             x_grad=x.grad.numpy(), gamma_grad=bn.gamma.grad.numpy(),
             beta_grad=bn.beta.grad.numpy(), pop_mean=bn.pop_mean.numpy(),
             pop_variance=bn.pop_variance.numpy())


def test_batchnorm_moments_are_global(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 5, 4, 3)) * 2 + 0.5).astype(np.float32)
    x[3:] = x[3:] * 3 - 1  # rank 1's rows have other moments
    w = rng.standard_normal(x.shape).astype(np.float32)
    np.savez(tmp_path / "x.npz", x=x, w=w)
    run_ranks(2, "tests.test_torch_parallel_step:rank_batchnorm",
              str(tmp_path / "x.npz"), str(tmp_path / "bn"),
              timeout=RANKS_TIMEOUT)
    got = [dict(np.load(tmp_path / f"bn.{r}.npz")) for r in range(2)]

    def one_process(xs, ws):
        bn = BatchNorm(x.shape[1]).train()
        xt = torch.from_numpy(xs).requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(ws)).sum().backward()
        return y.detach().numpy(), xt.grad.numpy(), bn

    y, xg, bn = one_process(x, w)
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]), y,
                               atol=1e-5)
    # the loss of the whole batch is the sum of the ranks' losses: each
    # rank's input gradient is the whole loss's, through the moments
    np.testing.assert_allclose(np.concatenate([g["x_grad"] for g in got]),
                               xg, atol=1e-5)
    for name in ("gamma", "beta"):
        np.testing.assert_allclose(
            sum(g[f"{name}_grad"] for g in got),
            getattr(bn, name).grad.numpy(), atol=1e-4, rtol=1e-5)
    for g in got:
        for name in ("pop_mean", "pop_variance"):
            np.testing.assert_allclose(g[name], getattr(bn, name).numpy(),
                                       atol=1e-6)
    # per-rank moments would give other outputs
    y_local = np.concatenate([one_process(x[:3], w[:3])[0],
                              one_process(x[3:], w[3:])[0]])
    assert np.abs(y_local - y).max() > 0.1


def _jax_mesh_step(jcfg, flat, batch, key, banks=None):
    """The JAX package's make_train_step under make_mesh(data=2) from the
    flat variables: (new state, metrics)."""
    t = jcfg.train
    tx = j_make_optimizer(t.alg, t.lr, t.mom)
    params = _nest({k[7:]: v for k, v in flat.items()
                    if k.startswith("params/")})
    stats = _nest({k[12:]: v for k, v in flat.items()
                   if k.startswith("batch_stats/")})
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=stats, opt_state=tx.init(params))
    mesh = j_make_mesh(data=2)
    step = j_make_train_step(jcfg, j_build_model(jcfg), tx, mesh=mesh,
                             donate=False, banked=banks is not None)
    state = jax.device_put(state, replicated_sharding(mesh))
    if banks is None:
        new, m = step(state, j_shard_batch(mesh, batch), key)
    else:
        new, m = step(state, jax.device_put(
            {k: jnp.asarray(v) for k, v in banks.items()},
            replicated_sharding(mesh)), j_shard_batch(mesh, batch), key)
    return new, {k: float(v) for k, v in m.items()}


def _compare_updates(got, flat, jnew):
    """Each parameter's update within DELTA_RTOL of its largest |delta|
    (noise biases aside) and the statistics at the step tests' bars."""
    want = {**_flat(jnew.params, "params"),
            **_flat(jnew.batch_stats, "batch_stats")}
    for key, w in want.items():
        g = got[key]
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(g, w, atol=STATS_ATOL, rtol=STATS_RTOL,
                                       err_msg=key)
            continue
        name = key[len("params/"):].replace("/", ".")
        if name.endswith(NOISE_BIASES):
            continue
        delta = w - flat[key]
        err = np.abs((g - flat[key]) - delta).max()
        # plus one float32 spacing of the weights: a gamma near 1 moved by
        # 1e-3 keeps only about 1e-4 of its update's digits
        bar = DELTA_RTOL * np.abs(delta).max() + np.spacing(np.abs(w).max())
        assert err <= bar, (key, err, bar)


def _banks(raw):
    n = L + 700
    pad = lambda x: np.pad(x, ((0, 0), (0, n - x.shape[1])))  # noqa: E731
    banks = {"speech": pad(np.concatenate([raw["clean"], raw["noise_a"]])),
             "speech_len": np.concatenate([raw["clean_len"], raw["len_a"]]),
             "speech_peak": np.concatenate([raw["peaks"][:, 0],
                                            raw["peaks"][:, 1]]),
             "noise": np.concatenate([pad(raw["noise_a"]), raw["noise_b"]]),
             "noise_len": np.concatenate([raw["len_a"], raw["len_b"]]),
             "noise_peak": np.concatenate([raw["peaks"][:, 1],
                                           raw["peaks"][:, 2]])}
    idx = {"clean_idx": np.array([1, 0], np.int32),
           "a_idx": np.array([3, 2], np.int32),
           "b_idx": np.array([0, 3], np.int32)}
    return banks, idx


@pytest.mark.parametrize("banked,boost", [(False, 0.0), (True, 2.0)])
def test_two_rank_step_equals_jax_mesh_step(tmp_path, banked, boost):
    jcfg, tcfg = twin_configs(
        "denoiser", model=SMALL_MODEL,
        data=dict(max_samples=L, slices_per_step=K),
        train=dict(alg="sgd", lr=1e-2, clean_loss_boost=boost))
    flat, key = _variables(jcfg, seed=1), jax.random.PRNGKey(9)
    batch = _batch(seed=4)
    draws = jax_train_draws(jcfg, key, 2, K)
    spec = dict(cfg=tcfg, data=2, model=1, min_channels=256,
                variables=flat, draws=draws, steps=1)
    if banked:
        banks, idx = _banks(batch)
        jnew, jm = _jax_mesh_step(jcfg, flat, idx, key, banks)
        outs = _run(tmp_path, 2, "dp", banks=banks, idx=idx, **spec)
    else:
        jnew, jm = _jax_mesh_step(jcfg, flat, batch, key)
        outs = _run(tmp_path, 2, "dp", batch=batch, **spec)
    for out in outs:  # every rank reports the global loss
        np.testing.assert_allclose(out["loss"][0], jm["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["grad_norm"][0], jm["grad_norm"],
                                   rtol=LOSS_RTOL)
    for key_ in outs[0]:  # the ranks hold the same weights
        np.testing.assert_array_equal(outs[1][key_], outs[0][key_])
    _compare_updates(outs[0], flat, jnew)


def rank_generator_step(rank, world, spec_path):
    """A rank of the generator check: ``rank_steps``'s set-up, but the
    draws and the embedding jitter come from ``step_generator``."""
    from nhans_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from nhans_tpu_torch.parallel.sharding_rules import shard_model

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    cfg = spec["cfg"]
    mesh = make_mesh(data=world)
    model = build_model(cfg)
    load_into(model, spec["variables"])
    shard_model(model, mesh)
    tx = make_tx(cfg)
    state = state_of(model, tx)
    batch = {k: torch.from_numpy(v)
             for k, v in shard_batch(mesh, spec["batch"]).items()}
    m = make_train_step(cfg, model, tx, mesh=mesh)(
        state, batch, step_generator(5, 0))
    np.savez(f"{spec['out']}.{rank}.npz", loss=float(m["loss"]),
             **{k: v.detach().numpy()
                for k, v in model.state_dict().items()})


def test_two_rank_draws_and_jitter_equal_one_rank(tmp_path):
    _, tcfg = twin_configs(
        "denoiser", model=dict(SMALL_MODEL, ctx_embed_noise=0.1),
        data=dict(max_samples=L, slices_per_step=K, augment_noise=True),
        train=dict(alg="sgd", lr=1e-2))
    jcfg, _ = twin_configs("denoiser", model=SMALL_MODEL,
                           data=dict(max_samples=L, slices_per_step=K))
    flat, batch = _variables(jcfg, seed=2), _batch(seed=5)
    # the ranks recompute the main tower in the backward pass: its
    # BatchNorms' all-reduces run again, on both ranks alike
    remat = tcfg.replace(model=dataclasses.replace(tcfg.model, remat=True))
    spec = dict(cfg=remat, variables=flat, batch=batch,
                out=str(tmp_path / "gen"))
    with open(tmp_path / "gen.pkl", "wb") as f:
        pickle.dump(spec, f)
    run_ranks(2, "tests.test_torch_parallel_step:rank_generator_step",
              str(tmp_path / "gen.pkl"), timeout=RANKS_TIMEOUT)
    got = dict(np.load(tmp_path / "gen.0.npz"))

    model = build_model(tcfg)
    load_into(model, flat)
    tx = make_tx(tcfg)
    state = state_of(model, tx)
    m = make_train_step(tcfg, model, tx)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        step_generator(5, 0))
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=LOSS_RTOL)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got[k], v.numpy(), atol=STATS_ATOL,
                                   rtol=STATS_RTOL, err_msg=k)


def test_model_axis_equals_data_axis(tmp_path):
    """data=2 x model=2 against data=2, two sgd steps from the same
    weights on the same batch and draws (the JAX test's bars); the
    sharding rule's threshold is cut to 16 channels for the reduced
    widths, so that the 16-wide kernels are split."""
    jcfg, tcfg = twin_configs("denoiser", model=SMALL_MODEL,
                              data=dict(max_samples=L, slices_per_step=K),
                              train=dict(alg="sgd", lr=1e-2))
    flat = _variables(jcfg, seed=3)
    spec = dict(cfg=tcfg, min_channels=16, variables=flat, batch=_batch(),
                draws=jax_train_draws(jcfg, jax.random.PRNGKey(7), 2, K),
                steps=2)
    dp = _run(tmp_path, 2, "dp", data=2, model=1, **spec)[0]
    tp = _run(tmp_path, 4, "tp", data=2, model=2, **spec)
    np.testing.assert_allclose(tp[0]["loss"], dp["loss"], rtol=1e-4)
    for key in dp:
        if key.startswith(("params/", "batch_stats/")):
            for out in tp:
                np.testing.assert_allclose(out[key], dp[key], atol=5e-5,
                                           err_msg=key)
    # kernels were held as halves of their output channels
    blocks = {k[len("block/"):]: v for k, v in tp[1].items()
              if k.startswith("block/")}
    assert "resblock2.conv1.w" in blocks and "last_conv.w" in blocks
    for name, shape in blocks.items():
        # flax layout: output channels last; the port's: OIHW dim 0, dense 1
        full = dp["params/" + name.replace(".", "/")].shape
        assert shape[0 if len(full) == 4 else 1] * 2 == full[-1], name
