"""The training golden tests/data/torch_golden_train.npz (written by
``python tests/make_torch_golden.py train``): one full-width sgd step of
the JAX package from the shipped denoiser weights, which chip_smoke.py
holds the port to on the card.  Here the inputs still regenerate, and
the port's step on the CPU gives the loss and the gradient norm within
1e-5 relative, each recorded update within 1e-3 of its largest |delta|
and the two BatchNorms' new statistics within 1e-5 (float32 on both
sides, convolutions summed in another order).

The bfloat16 golden tests/data/torch_golden_train_bf16.npz (``python
tests/make_torch_golden.py train_bf16``) records the same step in
bfloat16 and three distances of it: to the float32 step (``gap``), under
a 1e-6 perturbation of the weights (``spread``, the most over
``SPREAD_SEEDS`` draws) and to the same step compiled to round every
bfloat16 value (``strict``).  The port's bfloat16 step on the CPU is held
to the bars ``chip_smoke.py`` holds it to on the card: loss, gradient
norm, updates and the last BatchNorm's statistics within BF16_SPREAD_X
times the largest of the three, the first BatchNorm's statistics within
1e-6 absolute, inside its 2.5e-6 gap."""

import numpy as np
import pytest

from tests.make_torch_golden import (GOLDEN_TRAIN, GOLDEN_TRAIN_BF16,
                                     TRAIN_LAYERS, TRAIN_SEED, TRAIN_STATS,
                                     golden_train_inputs, input_digest,
                                     port_train_golden, train_gap)

BF16_SPREAD_X = 4.0
BF16_FIRST_BN_ATOL = 1e-6
DISTANCES = ("gap", "spread", "strict")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN_TRAIN) as z:
        return {k: z[k] for k in z.files}


def test_train_golden_inputs_regenerate(golden):
    assert int(golden["seed"]) == TRAIN_SEED
    assert str(golden["input_sha256"]) == input_digest(
        *golden_train_inputs().values())
    for path in TRAIN_LAYERS:
        assert np.abs(golden[f"delta/{path}"]).max() > 0, path


def test_port_step_reproduces_train_golden_on_cpu(golden):
    got = port_train_golden("cpu", golden)
    np.testing.assert_allclose(got["loss"], golden["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], golden["grad_norm"],
                               rtol=1e-4)
    for path in TRAIN_LAYERS:
        want = golden[f"delta/{path}"]
        np.testing.assert_allclose(got[f"delta/{path}"], want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=path)
    for path in TRAIN_STATS:
        for name in ("pop_mean", "pop_variance"):
            key = f"stats/{path}/{name}"
            np.testing.assert_allclose(got[key], golden[key], atol=1e-5,
                                       rtol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def golden_bf16():
    with np.load(GOLDEN_TRAIN_BF16) as z:
        return {k: z[k] for k in z.files}


def test_train_bf16_golden_has_the_float32_inputs_and_draws(golden,
                                                             golden_bf16):
    assert str(golden_bf16["input_sha256"]) == str(golden["input_sha256"])
    draws = [k for k in golden if k.startswith("draws/")]
    assert draws
    for k in draws:
        np.testing.assert_array_equal(golden_bf16[k], golden[k], err_msg=k)
    errs = train_gap(golden_bf16, golden_bf16, "x")
    for k in errs:
        for d in DISTANCES:
            assert np.isfinite(golden_bf16[f"{d}{k[1:]}"]), (d, k)
    # bfloat16 moves the first BatchNorm's statistics, which the bar sees
    assert float(golden_bf16[f"gap/stats/{TRAIN_STATS[0]}/pop_mean"]) \
        > BF16_FIRST_BN_ATOL


def test_port_bf16_step_within_golden_bars_on_cpu(golden_bf16):
    got = port_train_golden("cpu", golden_bf16, "bfloat16")
    for k, err in train_gap(golden_bf16, got, "x").items():
        key = k[len("x/"):]
        bar = (BF16_FIRST_BN_ATOL if key.startswith(f"stats/{TRAIN_STATS[0]}/")
               else BF16_SPREAD_X * max(float(golden_bf16[f"{d}/{key}"])
                                        for d in DISTANCES))
        assert err <= bar, (key, err, bar)
