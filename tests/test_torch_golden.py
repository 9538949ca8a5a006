"""The golden fixture tests/data/torch_golden_denoiser.npz (written by
tests/make_torch_golden.py), which chip_smoke.py holds the port to on the
card: the seeded inputs still regenerate, the JAX package still
reproduces it, and the port reproduces it on the CPU."""

import numpy as np
import pytest

from nhans_tpu_torch.compat.weights import load_npz
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.infer.enhance import Enhancer
from tests.make_torch_golden import (DENOISER_NPZ, GOLDEN, JAX_SNR_RTOL,
                                     JAX_WAVE_ATOL, SEED, golden_inputs,
                                     input_digest, jax_golden_run)

# the port on the CPU: float32 like the JAX package, another summation
# order in the convolutions (as in tests/test_torch_enhance.py)
PORT_WAVE_ATOL = 1e-4
PORT_SNR_RTOL = 1e-4


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _check(out, golden, wave_atol, snr_rtol):
    for key in ("denoised", "mixed_processed"):
        assert out[key].shape == golden[key].shape
        np.testing.assert_allclose(out[key], golden[key], atol=wave_atol)
    np.testing.assert_allclose(out["snr_est"], golden["snr_est"],
                               rtol=snr_rtol)
    np.testing.assert_allclose(out["cap_clip_frac"], golden["cap_clip_frac"],
                               atol=1e-6)


def test_golden_inputs_regenerate(golden):
    assert int(golden["seed"]) == SEED
    assert str(golden["input_sha256"]) == input_digest(*golden_inputs())
    assert golden["denoised"].dtype == np.float32
    assert np.isfinite(golden["denoised"]).all()


def test_jax_package_reproduces_golden(golden):
    _check(jax_golden_run(), golden, JAX_WAVE_ATOL, JAX_SNR_RTOL)


def test_port_reproduces_golden_on_cpu(golden):
    enh = Enhancer(Config.denoiser(), load_npz(DENOISER_NPZ), device="cpu")
    _check(enh.enhance(*golden_inputs()), golden, PORT_WAVE_ATOL,
           PORT_SNR_RTOL)
