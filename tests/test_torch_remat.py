"""Rematerialisation of the main tower (``ModelConfig.remat``): a train
step that recomputes each block in the backward pass equals the step that
keeps the activations, in loss, gradients, updates and BatchNorm
statistics, at reduced widths on the CPU.  The recomputation runs on the
same CPU kernels with the same inputs, so the bar is float32's own
rounding (1e-7 absolute + 1e-6 relative), far below what a second move of
the statistics gives (1 - decay = 5 % of the way to the batch's moments
again); the last test shows the comparison catches that.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from nhans_tpu_torch.compat.weights import to_flax
from nhans_tpu_torch.nn import model as model_mod
from nhans_tpu_torch.train.step import (make_train_step, make_tx, state_of,
                                        train_loss)
from tests.make_torch_golden import jax_train_draws, twin_configs
from tests.test_torch_train_step import (B, K, L, SMALL_MODEL, _batch, _port,
                                         _torch, _variables)

ATOL, RTOL = 1e-7, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(dtype, pad, remat, alg="adam"):
    """(metrics, params, buffers, grads of a separate forward/backward)
    after one step from the same seeded state."""
    import jax

    jcfg, tcfg = twin_configs(
        "denoiser", model=dict(SMALL_MODEL, compute_dtype=dtype,
                               freq_pad_to=pad, remat=remat),
        data=dict(max_samples=L, slices_per_step=K),
        train=dict(alg=alg, lr=1e-3))
    flat, batch, key = _variables(jcfg, seed=5), _batch(seed=9), \
        jax.random.PRNGKey(13)
    draws = _torch(jax_train_draws(jcfg, key, B, K))

    # gradients of one forward/backward, and the statistics it moved
    from nhans_tpu_torch.data.pipeline import make_train_batch
    model = _port(tcfg, flat).train()
    b = _torch(batch)
    ex = make_train_batch(tcfg, b["clean"], b["noise_a"], b["noise_b"],
                          b["clean_len"], b["len_a"], b["len_b"],
                          peaks=b["peaks"], draws=draws)
    train_loss(tcfg, model, ex).backward()
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    fwd_stats = to_flax(dict(model.named_buffers()), "batch_stats")

    model = _port(tcfg, flat)
    tx = make_tx(tcfg)
    state = state_of(model, tx)
    m = make_train_step(tcfg, model, tx)(state, b, None, draws=draws)
    return ({k: float(v) for k, v in m.items()},
            to_flax(dict(model.named_parameters()), "params"),
            to_flax(dict(model.named_buffers()), "batch_stats"),
            grads, fwd_stats)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("dtype,pad", [("float32", 0), ("bfloat16", 256)])
def test_remat_step_equals_plain_step(dtype, pad):
    m0, p0, s0, g0, f0 = _step(dtype, pad, remat=False)
    m1, p1, s1, g1, f1 = _step(dtype, pad, remat=True)
    # the test weights give the zero-initialised layers values, so every
    # layer has a gradient and the comparison reaches the whole tower
    assert all(np.abs(g).max() > 0 for g in g0.values())
    np.testing.assert_allclose(m1["loss"], m0["loss"], rtol=RTOL)
    np.testing.assert_allclose(m1["grad_norm"], m0["grad_norm"], rtol=RTOL)
    _assert_same(g1, g0)
    _assert_same(f1, f0)
    _assert_same(p1, p0)
    _assert_same(s1, s0)


def test_remat_checkpoints_every_block_and_recomputes(monkeypatch):
    """Each main-tower block runs under torch.utils.checkpoint, and runs
    again in the backward pass with its statistics frozen."""
    calls = []
    real = model_mod.checkpoint

    def counting(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(model_mod, "checkpoint", counting)
    frozen = []
    real_frozen = model_mod.frozen_stats

    @contextlib.contextmanager
    def noting(block):
        frozen.append(block)
        with real_frozen(block):
            yield

    monkeypatch.setattr(model_mod, "frozen_stats", noting)
    _step("float32", 0, remat=True, alg="sgd")
    n = len(SMALL_MODEL["main_blocks"])
    # two forwards (the gradient pass and the step), n blocks each
    assert len(calls) == 2 * n
    assert len(frozen) == 2 * n


def test_a_second_statistics_move_would_be_caught(monkeypatch):
    """Without the frozen statistics the recomputation moves every main
    tower BatchNorm a second time, and the comparison above fails."""
    _, _, s0, _, _ = _step("float32", 0, remat=False, alg="sgd")
    monkeypatch.setattr(model_mod, "frozen_stats",
                        lambda block: contextlib.nullcontext())
    _, _, s1, _, _ = _step("float32", 0, remat=True, alg="sgd")
    with pytest.raises(AssertionError):
        _assert_same(s1, s0)
    moved = [k for k in s0 if k.startswith("batch_stats/resblock")
             and not np.allclose(s1[k], s0[k], atol=ATOL, rtol=RTOL)]
    assert moved
