"""The optimizer zoo of the reference's ``--alg`` flag, with TF1's default
hyper-parameters, as plain functions on dicts of tensors: the port of
``nhans_tpu/train/optim.py``.

The update rules are optax 0.2.6's, which the JAX package uses, and not
``torch.optim``'s, which differ:

* sgd: ``-lr * g``; momentum: ``t = g + mom * t``, ``-lr * t``;
* rmsprop: ``nu = 0.9 nu + 0.1 g^2`` with ``nu`` starting at ONES,
  ``-lr * g * rsqrt(nu + 1e-10)`` (eps inside the root), then
  ``t = u + mom * t`` when ``--mom`` is set;
* adadelta: ``e_g = 0.95 e_g + 0.05 g^2``,
  ``u = sqrt(e_x + 1e-8) / sqrt(e_g + 1e-8) * g``,
  ``e_x = 0.95 e_x + 0.05 u^2``, ``-lr * u``;
* adagrad: ``acc = acc + g^2`` with ``acc`` starting at 0.1,
  ``-lr * g * rsqrt(acc + 1e-7)`` where ``acc > 0``, else 0;
* adam: ``m = 0.9 m + 0.1 g``, ``v = 0.999 v + 0.001 g^2``,
  ``-lr * m_hat / (sqrt(v_hat) + 1e-8)`` with the bias corrections
  ``1 - b^t``.

An optimizer is ``Optimizer(init, update)``: ``init(params)`` gives the
state, ``update(grads, state)`` gives ``(updates, new_state)``, and the
caller adds the updates to the parameters.  The learning rate is a
number or a schedule of the update count.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Union

import torch

Tensors = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], dict]
    update: Callable[[Tensors, dict], tuple]


def make_schedule(lr: float, schedule: str = "constant",
                  decay_steps: int = 0, lr_min_frac: float = 0.1
                  ) -> LearningRate:
    """``constant`` (the reference's fixed ``--lr``) or ``cosine``: lr
    decays to ``lr * lr_min_frac`` over ``decay_steps`` updates, then
    holds (optax's ``cosine_decay_schedule``)."""
    if schedule == "constant" or not decay_steps:
        return lr
    if schedule == "cosine":
        def cosine(count: int) -> float:
            t = min(float(count), float(decay_steps))
            decayed = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
            return lr * ((1.0 - lr_min_frac) * decayed + lr_min_frac)
        return cosine
    raise ValueError(f"unknown lr schedule {schedule!r}")


def _zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _full(params: Tensors, value: float) -> Tensors:
    return {k: torch.full_like(v, value) for k, v in params.items()}


def _scale(lr: LearningRate, count: int) -> float:
    """-lr at this update count (the step size of optax's
    ``scale_by_learning_rate``)."""
    return -(lr(count) if callable(lr) else lr)


def make_optimizer(alg: str, lr: LearningRate, mom: float = 0.0) -> Optimizer:
    """sgd / momentum / rmsprop / adadelta / adagrad / adam."""
    alg = alg.lower()
    if alg in ("sgd", "momentum"):
        decay = mom if alg == "momentum" else None

        def init(params):
            state = {"count": 0}
            if decay is not None:
                state["trace"] = _zeros(params)
            return state

        def update(grads, state):
            step = _scale(lr, state["count"])
            new = {"count": state["count"] + 1}
            if decay is None:
                return {k: step * g for k, g in grads.items()}, new
            trace = {k: g + decay * state["trace"][k]
                     for k, g in grads.items()}
            new["trace"] = trace
            return {k: step * t for k, t in trace.items()}, new
        return Optimizer(init, update)

    if alg == "rmsprop":
        d, eps, use_mom = 0.9, 1e-10, bool(mom)

        def init(params):
            state = {"count": 0, "nu": _full(params, 1.0)}
            if use_mom:
                state["trace"] = _zeros(params)
            return state

        def update(grads, state):
            step = _scale(lr, state["count"])
            nu = {k: (1 - d) * g * g + d * state["nu"][k]
                  for k, g in grads.items()}
            upd = {k: step * (torch.rsqrt(nu[k] + eps) * g)
                   for k, g in grads.items()}
            new = {"count": state["count"] + 1, "nu": nu}
            if use_mom:
                upd = {k: u + mom * state["trace"][k] for k, u in upd.items()}
                new["trace"] = upd
            return upd, new
        return Optimizer(init, update)

    if alg == "adadelta":
        rho, eps = 0.95, 1e-8

        def init(params):
            return {"count": 0, "e_g": _zeros(params), "e_x": _zeros(params)}

        def update(grads, state):
            step = _scale(lr, state["count"])
            e_g = {k: (1 - rho) * g * g + rho * state["e_g"][k]
                   for k, g in grads.items()}
            u = {k: torch.sqrt(state["e_x"][k] + eps)
                 / torch.sqrt(e_g[k] + eps) * g for k, g in grads.items()}
            e_x = {k: (1 - rho) * v * v + rho * state["e_x"][k]
                   for k, v in u.items()}
            return ({k: step * v for k, v in u.items()},
                    {"count": state["count"] + 1, "e_g": e_g, "e_x": e_x})
        return Optimizer(init, update)

    if alg == "adagrad":
        eps = 1e-7

        def init(params):
            return {"count": 0, "sum_of_squares": _full(params, 0.1)}

        def update(grads, state):
            step = _scale(lr, state["count"])
            acc = {k: g * g + state["sum_of_squares"][k]
                   for k, g in grads.items()}
            upd = {k: step * (torch.where(acc[k] > 0,
                                          torch.rsqrt(acc[k] + eps),
                                          torch.zeros_like(g)) * g)
                   for k, g in grads.items()}
            return upd, {"count": state["count"] + 1, "sum_of_squares": acc}
        return Optimizer(init, update)

    if alg == "adam":
        b1, b2, eps = 0.9, 0.999, 1e-8

        def init(params):
            return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

        def update(grads, state):
            step = _scale(lr, state["count"])
            t = state["count"] + 1
            mu = {k: (1 - b1) * g + b1 * state["mu"][k]
                  for k, g in grads.items()}
            nu = {k: (1 - b2) * g * g + b2 * state["nu"][k]
                  for k, g in grads.items()}
            # the corrections in float32, as optax takes them
            c1 = float(torch.tensor(1.0) - torch.tensor(b1) ** t)
            c2 = float(torch.tensor(1.0) - torch.tensor(b2) ** t)
            upd = {k: step * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
                   for k in grads}
            return upd, {"count": t, "mu": mu, "nu": nu}
        return Optimizer(init, update)

    raise ValueError(f"unknown optimizer --alg={alg!r}; expected one of "
                     "sgd|momentum|rmsprop|adadelta|adagrad|adam")
