"""The port's scoring (nhans_tpu_torch/utils/scoring.py, pesq_np.py)
against the JAX package's on the same seeded signals, within 1e-9, and
the property tests of tests/test_scoring.py and tests/test_pesq.py
that need no files, run on the port's copies (the tests on the
reference's demo recordings, which this tree does not hold, are left
to the JAX package's files)."""

import numpy as np
import pytest

from nhans_tpu.utils import pesq_np as j_pesq_np
from nhans_tpu.utils import scoring as j_scoring
from nhans_tpu_torch.utils import pesq_np as t_pesq_np
from nhans_tpu_torch.utils import scoring as t_scoring
from nhans_tpu_torch.utils.pesq_np import pesq_np
from nhans_tpu_torch.utils.scoring import (estoi, lsd, pesq_score, sdr,
                                           si_sdr, snr_improvement, stoi)


def _speech_like(n, fs=16000, seed=0):
    """A voiced harmonic stack (partials to about 4 kHz, 1/k rolloff) with
    an AM envelope, int16 scale."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = 120.0 + 10.0 * np.sin(2 * np.pi * 2.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(np.sin(k * phase) / k for k in range(1, 30))
    env = 0.5 + 0.5 * np.clip(np.sin(2 * np.pi * 3.0 * t), 0, 1)
    x = x * env + 0.01 * rng.standard_normal(n)
    return (x / np.max(np.abs(x)) * 8000.0).astype(np.float64)


def _pair(seed, n=24000, fs=16000, snr_db=5.0, lag=0):
    """(estimate, reference): the reference speech-like, the estimate the
    reference in noise, one shorter than the other by 37 samples."""
    rng = np.random.default_rng(seed)
    ref = _speech_like(n, fs, seed)
    noise = rng.standard_normal(n + lag)
    noise *= np.sqrt(np.mean(ref ** 2) / 10 ** (snr_db / 10)
                     / np.mean(noise ** 2))
    est = np.concatenate([np.zeros(lag), ref])[:n + lag] + noise
    return est[:n - 37].astype(np.float32), ref


@pytest.mark.parametrize("name, seed, fs, snr_db", [
    ("si_sdr", 1, 16000, 5.0), ("si_sdr", 2, 16000, -5.0),
    ("sdr", 3, 16000, 10.0), ("lsd", 4, 16000, 0.0),
    ("snr_improvement", 5, 16000, 0.0),
    ("stoi", 6, 16000, 0.0), ("stoi", 7, 16000, 20.0),
    ("estoi", 8, 16000, 0.0), ("estoi", 9, 16000, 20.0),
    ("pesq_score", 10, 16000, 5.0), ("pesq_score", 11, 8000, 15.0),
    ("pesq_np_wb", 12, 16000, 10.0), ("pesq_np_nb", 13, 8000, 10.0),
])
def test_scores_match_jax(name, seed, fs, snr_db):
    est, ref = _pair(seed, n=int(1.6 * fs), fs=fs, snr_db=snr_db,
                     lag=40 if name.startswith("pesq") else 0)
    if name.startswith("pesq_np"):
        mode = name[-2:]
        got = t_pesq_np.pesq_np(fs, ref, est, mode)
        want = j_pesq_np.pesq_np(fs, ref, est, mode)
    elif name == "snr_improvement":
        mixed = est + 0.5 * np.random.default_rng(seed).standard_normal(
            len(est)) * 3000
        got = t_scoring.snr_improvement(mixed, est, ref)
        want = j_scoring.snr_improvement(mixed, est, ref)
    elif name in ("stoi", "estoi", "pesq_score"):
        got = getattr(t_scoring, name)(est, ref, fs)
        want = getattr(j_scoring, name)(est, ref, fs)
    else:
        got = getattr(t_scoring, name)(est, ref)
        want = getattr(j_scoring, name)(est, ref)
    assert np.isfinite(want), (name, want)
    assert abs(got - want) <= 1e-9, (name, got, want)


def test_si_sdr_identity(rng):
    x = rng.standard_normal(8000)
    assert si_sdr(x, x) > 100
    assert si_sdr(3.7 * x, x) > 100  # scale-invariant
    assert sdr(x, x) > 100
    assert sdr(2 * x, x) < 10        # not scale-invariant


def test_si_sdr_known_value(rng):
    x = rng.standard_normal(8000)
    n = rng.standard_normal(8000)
    n -= (n @ x) / (x @ x) * x       # orthogonalise
    a = np.sqrt((x @ x) / (n @ n) / 10 ** (5 / 10))  # 5 dB
    assert abs(si_sdr(x + a * n, x) - 5.0) < 0.2


def test_snr_improvement(rng):
    x = rng.standard_normal(8000)
    noise = rng.standard_normal(8000)
    assert snr_improvement(x + 0.5 * noise, x + 0.1 * noise, x) > 10


def test_lsd_zero_for_identical(rng):
    x = rng.standard_normal(8000)
    assert lsd(x, x) < 1e-6
    assert lsd(x, x + 0.3 * rng.standard_normal(8000)) > 1.0


def test_stoi_properties(rng):
    fs = 16000
    t = np.arange(fs * 3) / fs
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t)
    x = env * (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 900 * t)
               + 0.3 * np.sin(2 * np.pi * 1800 * t))
    clean = stoi(x, x, fs)
    assert clean > 0.95, clean
    noise = rng.standard_normal(len(x))
    light = stoi(x + 0.1 * noise, x, fs)
    heavy = stoi(x + 2.0 * noise, x, fs)
    assert clean >= light > heavy, (clean, light, heavy)
    assert heavy < 0.8


def test_estoi_properties(rng):
    fs = 16000
    t = np.arange(fs * 3) / fs
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t)
    x = env * rng.standard_normal(len(t))
    clean = estoi(x, x, fs)
    assert clean > 0.95, clean
    noise = rng.standard_normal(len(x))
    light = estoi(x + 0.2 * noise, x, fs)
    heavy = estoi(x + 2.0 * noise, x, fs)
    assert clean > light > heavy, (clean, light, heavy)


def test_stoi_too_short_is_nan():
    """Fewer than 30 frames at 10 kHz: no score, as the evaluator skips."""
    x = _speech_like(4000)
    assert np.isnan(stoi(x, x)) and np.isnan(estoi(x, x))


def test_pesq_identity_scores_max():
    x = _speech_like(32000)
    assert pesq_np(16000, x, x) > 4.0


def test_pesq_bounds_and_noise_floor():
    rng = np.random.default_rng(1)
    x = _speech_like(32000)
    lo = pesq_np(16000, x, rng.standard_normal(32000) * 8000.0)
    assert 1.0 <= lo <= 5.0
    assert lo < 3.0
    assert pesq_np(16000, x, x) - lo > 1.5


def test_pesq_monotonic_in_snr():
    rng = np.random.default_rng(2)
    x = _speech_like(48000)
    noise = rng.standard_normal(48000)
    noise = noise / np.sqrt(np.mean(noise ** 2))
    sig_rms = np.sqrt(np.mean(x ** 2))
    scores = [pesq_np(16000, x, x + sig_rms / 10.0 ** (s / 20.0) * noise)
              for s in (0, 10, 20, 30)]
    assert scores == sorted(scores), scores
    assert scores[-1] > scores[0] + 0.5


def test_pesq_constant_delay_invariance():
    x = _speech_like(48000)
    deg = x + 300.0 * np.random.default_rng(3).standard_normal(len(x))
    base = pesq_np(16000, x, deg)
    shifted = pesq_np(16000, x, np.concatenate([np.zeros(800), deg]))
    assert abs(base - shifted) < 0.35


def test_pesq_narrowband_mode():
    x = _speech_like(24000, fs=8000)
    assert pesq_np(8000, x, x, mode="nb") > 3.5


def test_pesq_score_always_available():
    """Without the C package pesq_score falls back to the numpy P.862."""
    x = _speech_like(32000)
    s = pesq_score(x * 0.9, x)
    assert s is not None and 1.0 <= s <= 5.0
    tone = np.sin(np.arange(32000) / 16000 * 2 * np.pi * 440)
    out = pesq_score(tone, tone)
    assert out is None or out > 3.0


def test_pesq_degradation_ordering():
    x = _speech_like(48000)
    mild = np.convolve(x, np.ones(3) / 3.0, mode="same")
    harsh = np.convolve(x, np.ones(33) / 33.0, mode="same")
    assert pesq_np(16000, x, mild) > pesq_np(16000, x, harsh)


def test_pesq_conformance_vs_reference_pesq_package():
    """Within a band of the ITU P.862 C sources' score, when the `pesq`
    package is installed."""
    ref_pesq = pytest.importorskip("pesq")
    fs = 16000
    ref = _speech_like(4 * fs)
    rng = np.random.default_rng(7)
    for snr_db, tol in ((30.0, 0.6), (10.0, 0.6), (0.0, 0.8)):
        noise = rng.standard_normal(len(ref))
        noise *= np.sqrt(np.mean(ref ** 2) / 10 ** (snr_db / 10)
                         / np.mean(noise ** 2))
        deg = ref + noise
        want = ref_pesq.pesq(fs, ref / 32768.0, deg / 32768.0, "wb")
        assert abs(pesq_np(fs, ref, deg, mode="wb") - want) <= tol
