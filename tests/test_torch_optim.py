"""The port's optimizer zoo (nhans_tpu_torch/train/optim.py): two updates
on known gradients against the update rules in numpy (float64) and
against optax through the JAX package's make_optimizer, within 1e-5
relative (float32 arithmetic on both sides), and the cosine schedule
against optax's within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nhans_tpu.train.optim import make_optimizer as j_make_optimizer
from nhans_tpu.train.optim import make_schedule as j_make_schedule
from nhans_tpu_torch.train.optim import make_optimizer, make_schedule

LR = 0.05
G1 = np.asarray([0.3, -1.2, 0.0, 2.5], np.float32)
G2 = np.asarray([-0.7, 0.4, 1.1, -0.2], np.float32)
THETA0 = np.asarray([1.0, -2.0, 0.5, 0.0], np.float32)
RTOL = 1e-5


def run_port(alg, mom=0.0, lr=LR, steps=(G1, G2)):
    tx = make_optimizer(alg, lr, mom)
    theta = torch.from_numpy(THETA0.copy())
    state = tx.init({"w": theta})
    for g in steps:
        updates, state = tx.update({"w": torch.from_numpy(g)}, state)
        theta = theta + updates["w"]
    return theta.numpy()


def run_optax(alg, mom=0.0, lr=LR, steps=(G1, G2)):
    tx = j_make_optimizer(alg, lr, mom)
    params = {"w": jnp.asarray(THETA0)}
    state = tx.init(params)
    for g in steps:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
    return np.asarray(params["w"])


def _rules(alg, mom):
    """The update rules in float64 numpy (tests/test_optim.py's)."""
    theta = THETA0.astype(np.float64)
    gs = [g.astype(np.float64) for g in (G1, G2)]
    if alg == "sgd":
        return theta - LR * gs[0] - LR * gs[1]
    if alg == "momentum":
        acc = np.zeros_like(theta)
        for g in gs:
            acc = mom * acc + g
            theta = theta - LR * acc
        return theta
    if alg == "rmsprop":
        ms, trace = np.ones_like(theta), np.zeros_like(theta)
        for g in gs:
            ms = 0.9 * ms + 0.1 * g * g
            trace = mom * trace + LR * g / np.sqrt(ms + 1e-10)
            theta = theta - trace
        return theta
    if alg == "adadelta":
        acc, accu = np.zeros_like(theta), np.zeros_like(theta)
        for g in gs:
            acc = 0.95 * acc + 0.05 * g * g
            upd = g * np.sqrt(accu + 1e-8) / np.sqrt(acc + 1e-8)
            accu = 0.95 * accu + 0.05 * upd * upd
            theta = theta - LR * upd
        return theta
    if alg == "adagrad":
        acc = np.full_like(theta, 0.1)
        for g in gs:
            acc = acc + g * g
            theta = theta - LR * g / np.sqrt(acc + 1e-7)
        return theta
    if alg == "adam":
        m, v = np.zeros_like(theta), np.zeros_like(theta)
        for t, g in enumerate(gs, start=1):
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            theta = theta - LR * (m / (1 - 0.9 ** t)) / (
                np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        return theta
    raise AssertionError(alg)


@pytest.mark.parametrize("alg,mom", [
    ("sgd", 0.0), ("momentum", 0.9), ("rmsprop", 0.0), ("rmsprop", 0.5),
    ("adadelta", 0.0), ("adagrad", 0.0), ("adam", 0.0)])
def test_two_updates_follow_the_rules_and_optax(alg, mom):
    got = run_port(alg, mom)
    np.testing.assert_allclose(got, _rules(alg, mom), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got, run_optax(alg, mom), rtol=RTOL,
                               atol=1e-7)


def test_cosine_schedule_matches_optax():
    port = make_schedule(0.01, "cosine", 100, 0.1)
    ref = j_make_schedule(0.01, "cosine", 100, 0.1)
    for count in (0, 1, 37, 99, 100, 250):
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6)
    assert make_schedule(0.01, "constant", 100) == 0.01
    assert make_schedule(0.01, "cosine", 0) == 0.01
    # the schedule drives the updates: sgd's step shrinks with the count
    got = run_port("sgd", lr=port)
    np.testing.assert_allclose(got, run_optax("sgd", lr=ref), rtol=RTOL)


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        make_optimizer("lion", 1e-3)
    with pytest.raises(ValueError):
        make_schedule(1e-3, "linear", 10)
