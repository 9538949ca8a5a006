"""The training golden tests/data/torch_golden_train.npz (written by
``python tests/make_torch_golden.py train``): one full-width sgd step of
the JAX package from the shipped denoiser weights, which chip_smoke.py
holds the port to on the card.  Here the inputs still regenerate, and
the port's step on the CPU gives the loss and the gradient norm within
1e-5 relative, each recorded update within 1e-3 of its largest |delta|
and the two BatchNorms' new statistics within 1e-5 (float32 on both
sides, convolutions summed in another order)."""

import numpy as np
import pytest

from tests.make_torch_golden import (GOLDEN_TRAIN, TRAIN_LAYERS, TRAIN_SEED,
                                     TRAIN_STATS, golden_train_inputs,
                                     input_digest, port_train_golden)


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
