"""The port's mixing (nhans_tpu_torch/dsp/mixing.py) and training batch
(nhans_tpu_torch/data/pipeline.py::make_train_batch) against the JAX
package on the same numpy-seeded buffers, on the CPU.

Mixing: float32 elementwise work and masked sums over a few thousand
samples on both sides, so each output within 1e-6 (signals of peak about
1); the md5 SNR index is equal.  The training batch is fed the reference's
own random draws (tests/make_torch_golden.py::jax_train_draws replays its
jax.random splits); every output within 1e-4: log-magnitudes of about
-11.5 to 5, JAX's from a float32 DFT (within about 6e-5 of float64 at
bins of small magnitude), and crops that must pick the same frames (a
wrong frame moves values by far more than 1e-4).  The port's batch takes
its spectrograms from the plain version evaluated in float64 here: two
float32 DFTs that sum their 400 products in different orders each miss
float64 by up to about 1e-4 at such bins, and their sum of misses would
measure the DFTs' rounding, not the batch.  The plain version's float32
rounding is held to the JAX package in tests/test_torch_stft_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhans_tpu.data.pipeline import make_train_batch as j_make_train_batch
from nhans_tpu.dsp import mixing as jmx
from nhans_tpu_torch.data.pipeline import (draw_train_batch,
                                           make_train_batch)
from nhans_tpu_torch.dsp import mixing as tmx
from nhans_tpu_torch.ops import stft_cuda
from tests.make_torch_golden import jax_train_draws, twin_configs

MIX_ATOL = 1e-6
BATCH_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    a pool that contends for the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(7)
    L = 3000
    x = rng.standard_normal((3, L)).astype(np.float32)
    x[0] *= 0.3
    x[2] *= 2.0
    lens = np.array([3000, 1777, 400], np.int32)
    return x, lens


def test_peak_normalize_and_loop_or_trim(wave):
    x, lens = wave
    _close(tmx.peak_normalize(_t(x), _t(lens)),
           jmx.peak_normalize(jnp.asarray(x), jnp.asarray(lens)), MIX_ATOL)
    peaks = np.array([5.0, 0.5, 3.0], np.float32)
    _close(tmx.peak_normalize(_t(x), _t(lens), _t(peaks)),
           jmx.peak_normalize(jnp.asarray(x), jnp.asarray(lens),
                              jnp.asarray(peaks)), MIX_ATOL)
    target = np.array([2500, 3000, 1000], np.int32)
    _close(tmx.loop_or_trim(_t(x), _t(lens), _t(target)),
           jmx.loop_or_trim(jnp.asarray(x), jnp.asarray(lens),
                            jnp.asarray(target)), MIX_ATOL)
    _close(tmx.loop_or_trim(_t(x[1]), 900, 2999),
           jmx.loop_or_trim(jnp.asarray(x[1]), 900, 2999), MIX_ATOL)


def test_power_and_gains_with_silent_noise(wave):
    x, lens = wave
    _close(tmx._power(_t(x), _t(lens)),
           jmx._power(jnp.asarray(x), jnp.asarray(lens)), MIX_ATOL)
    psig = np.array([0.5, 1.0, 2.0], np.float32)
    pnoise = np.array([0.25, 0.0, 3.0], np.float32)  # K = 1 where silent
    snr = np.array([-3.0, 5.0, 8.0], np.float32)
    got = tmx.mixing_gains(_t(psig), _t(pnoise), _t(snr))
    _close(got, jmx.mixing_gains(jnp.asarray(psig), jnp.asarray(pnoise),
                                 jnp.asarray(snr)), MIX_ATOL)
    assert float(got[1]) == 1.0


def test_mixers(wave):
    x, lens = wave
    clean_len = np.array([2880, 1680, 400], np.int32)
    snr_a = np.array([-3.0, 0.0, 8.0], np.float32)
    snr_b = np.array([5.0, 3.0, -3.0], np.float32)
    c = jmx.peak_normalize(jnp.asarray(x), jnp.asarray(clean_len))
    pos = np.roll(x, 500, axis=1)
    neg = np.roll(x, 1300, axis=1)
    pos[1] = 0.0  # a silent noise takes K = 1
    got = tmx.mix_two_noise(_t(np.asarray(c)), _t(pos), _t(neg),
                            _t(clean_len), _t(lens), _t(lens[::-1].copy()),
                            _t(snr_a), _t(snr_b))
    want = jmx.mix_two_noise(c, jnp.asarray(pos), jnp.asarray(neg),
                             jnp.asarray(clean_len), jnp.asarray(lens),
                             jnp.asarray(lens[::-1].copy()),
                             jnp.asarray(snr_a), jnp.asarray(snr_b))
    for g, w in zip(got, want):
        _close(g, w, MIX_ATOL)
    got = tmx.mix_one_noise(_t(np.asarray(c)), _t(neg), _t(clean_len),
                            _t(lens), _t(snr_a))
    want = jmx.mix_one_noise(c, jnp.asarray(neg), jnp.asarray(clean_len),
                             jnp.asarray(lens), jnp.asarray(snr_a))
    for g, w in zip(got, want):
        _close(g, w, MIX_ATOL)


def test_snr_index_from_path_is_equal():
    for path in ("/data/speech/valid/u0.wav", "spk3_x.wav", b"bytes.wav",
                 "üñí.wav"):
        for n in (5, 7, 8):
            for prefix in (6, 8):
                assert (tmx.snr_index_from_path(path, n, prefix)
                        == jmx.snr_index_from_path(path, n, prefix))


# --------------------------------------------------------------------------
# the training batch

FRAMES = 400 + 160 * 40  # 41 frames in the wire buffer


def _buffers(seed, L, noise_lengths, clean_len):
    """Waveform buffers at int16 scale, as the loaders deliver them."""
    rng = np.random.default_rng(seed)
    B = len(clean_len)
    t = np.arange(L) / 16000.0
    clean = np.stack([6000 * np.sin(2 * np.pi * (150 + 70 * b) * t)
                      + rng.standard_normal(L) * 800 for b in range(B)])
    clean = np.rint(clean).astype(np.int16)
    noises = []
    for nl in noise_lengths:
        noises.append(np.rint(rng.standard_normal((B, nl)) * 2500)
                      .astype(np.int16))
    for b, n in enumerate(clean_len):
        clean[b, n:] = 0
    return clean, noises


CASES = {
    # name: (task, W, C, L, noise buffer lengths (a, b), clean lengths,
    #        valid lengths of noise a and of noise b, data fields)
    "denoiser_noise_longer_and_shorter": (
        "denoiser", 9, 20, FRAMES, (FRAMES + 1000, FRAMES - 2400),
        (FRAMES, FRAMES - 777), ((FRAMES + 1000, FRAMES + 500),
                                 (FRAMES - 2400, 1900)), {}),
    "denoiser_short_utterance_augment": (
        "denoiser", 9, 20, FRAMES, (FRAMES, FRAMES),
        (400 + 160 * 12, FRAMES - 160), ((FRAMES, 5000), (3000, FRAMES)),
        dict(augment_noise=True)),
    "denoiser_even_window_snr_augment": (
        "denoiser", 8, 20, FRAMES, (FRAMES, FRAMES),
        (FRAMES - 31, FRAMES), ((FRAMES, FRAMES), (FRAMES, 2000)),
        dict(snr_augment=True)),
    "separator_interference_longer_and_short": (
        "separator", 9, 20, FRAMES, (FRAMES + 3000, FRAMES),
        (FRAMES, 400 + 160 * 15), ((FRAMES + 3000, 400 + 160 * 10),
                                   (0, 0)), {}),
}


@pytest.fixture
def float64_spectrogram(monkeypatch):
    """The port's spectrograms from the plain version taken in float64."""
    plain = stft_cuda.log_spectrogram_plain

    def exact(x, with_reim=False):
        outs = plain(x.double(), True)
        outs = tuple(t.to(x.dtype) for t in outs)
        return outs if with_reim else outs[0]

    monkeypatch.setattr(stft_cuda, "log_spectrogram_kernel", exact)


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_train_batch_matches_jax(case, float64_spectrogram):
    task, W, C, L, noise_bufs, clean_len, noise_lens, data = CASES[case]
    jcfg, tcfg = twin_configs(
        task, model=dict(window_frames=W, context_frames=C),
        data=dict(max_samples=L, **data))
    clean, (na, nb) = _buffers(sum(map(ord, case)), L, noise_bufs, clean_len)
    clean_len = np.asarray(clean_len, np.int32)
    len_a, len_b = (np.asarray(v, np.int32) for v in noise_lens)
    peaks = np.stack([np.abs(clean).max(1), np.abs(na).max(1) * 1.1,
                      np.abs(nb).max(1)], axis=1).astype(np.float32)
    K = 3
    key = jax.random.PRNGKey(11)
    want = j_make_train_batch(
        jcfg, key, jnp.asarray(clean), jnp.asarray(na), jnp.asarray(nb),
        jnp.asarray(clean_len), jnp.asarray(len_a), jnp.asarray(len_b),
        slices=K, peaks=jnp.asarray(peaks), stft_impl="xla")
    draws = {k: _t(v) for k, v in
             jax_train_draws(jcfg, key, len(clean_len), K).items()}
    got = make_train_batch(tcfg, _t(clean), _t(na), _t(nb), _t(clean_len),
                           _t(len_a), _t(len_b), slices=K, peaks=_t(peaks),
                           draws=draws)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k], BATCH_ATOL)
    # the crops read real frames: a context is never all zero padding
    assert float(got["ctx_a"].abs().amax(dim=(1, 2)).min()) > 0


def test_draws_from_a_generator_are_seeded():
    _, tcfg = twin_configs("denoiser", data=dict(augment_noise=True))
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    d1 = draw_train_batch(tcfg, 4, 2, g1)
    d2 = draw_train_batch(tcfg, 4, 2, g2)
    assert set(d1) == {"snr_a", "snr_b", "u_win", "u_ctx_a", "u_ctx_b",
                       "shift_a", "rev_a", "sign_a", "shift_b", "rev_b",
                       "sign_b"}
    for k in d1:
        assert torch.equal(d1[k], d2[k])
    assert int(d1["snr_a"].max()) < len(tcfg.task.snr_set)
    assert set(d1["sign_a"].tolist()) <= {-1.0, 1.0}
