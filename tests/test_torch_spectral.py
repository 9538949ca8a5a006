"""nhans_tpu_torch.dsp.spectral against its JAX twin nhans_tpu.dsp.spectral
on the same seeded signals.  Bars: log-magnitude atol 1e-4; re/im and
istft within 1e-4 x the largest magnitude (float32 products of 400 terms
summed in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nhans_tpu.dsp.spectral as J
import nhans_tpu_torch.dsp.spectral as T

# F = 0, F = 1, a ragged tail, many frames
LENGTHS = [399, 400, 4037, 16000]


def _sig(rng, shape):
    return (rng.standard_normal(shape) * 3000.0).astype(np.float32)


def _tol(ref):
    return 1e-4 * max(float(np.abs(ref).max(initial=0.0)), 1.0)


def test_windows_and_bases_identical():
    np.testing.assert_array_equal(T._synthesis_window_np(400, 160),
                                  J._synthesis_window_np(400, 160))
    for a, b in zip(T._dft_bases_np(400, 201), J._dft_bases_np(400, 201)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(T._idft_bases_np(400, 201), J._idft_bases_np(400, 201)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(T.hann_window(400).numpy(),
                                  np.asarray(J.hann_window(400)))
    np.testing.assert_array_equal(T.synthesis_window(400, 160).numpy(),
                                  np.asarray(J.synthesis_window(400, 160)))


@pytest.mark.parametrize("L", LENGTHS + [559, 560])
def test_num_frames_and_frame_signal(rng, L):
    assert T.num_frames(L) == J.num_frames(L)
    x = _sig(rng, (2, L))
    got = T.frame_signal(torch.from_numpy(x)).numpy()
    ref = np.asarray(J.frame_signal(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("L", LENGTHS)
def test_stft_and_log_magnitude(rng, L):
    x = _sig(rng, (2, L))
    re, im = T.stft(torch.from_numpy(x))
    jre, jim = J.stft(jnp.asarray(x))
    assert re.shape == jre.shape == (2, J.num_frames(L), 201)
    jre, jim = np.asarray(jre), np.asarray(jim)
    tol = _tol(jre)
    np.testing.assert_allclose(re.numpy(), jre, atol=tol)
    np.testing.assert_allclose(im.numpy(), jim, atol=tol)
    lm = T.log_magnitude(re, im).numpy()
    np.testing.assert_allclose(
        lm, np.asarray(J.log_magnitude(jnp.asarray(re.numpy()),
                                       jnp.asarray(im.numpy()))), atol=1e-4)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("batched", [False, True])
def test_spectrogram_reim_and_log_spectrogram(rng, L, batched):
    x = _sig(rng, (3, L) if batched else (L,))
    lm, re, im = T.spectrogram_reim(torch.from_numpy(x))
    jlm, jre, jim = (np.asarray(a) for a in
                     J.spectrogram_reim(jnp.asarray(x), impl="xla"))
    assert lm.shape == jlm.shape
    np.testing.assert_allclose(lm.numpy(), jlm, atol=1e-4)
    tol = _tol(jre)
    np.testing.assert_allclose(re.numpy(), jre, atol=tol)
    np.testing.assert_allclose(im.numpy(), jim, atol=tol)
    lm_only = T.log_spectrogram(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        lm_only, np.asarray(J.log_spectrogram(jnp.asarray(x), impl="xla")),
        atol=1e-4)


def test_spectrogram_rejects_other_geometry(rng):
    x = torch.from_numpy(_sig(rng, (1, 4000)))
    with pytest.raises(ValueError):
        T.log_spectrogram(x, frame_length=512)
    with pytest.raises(ValueError):
        T.spectrogram_reim(x[None])


@pytest.mark.parametrize("frames", [1, 7, 40])
def test_overlap_add(rng, frames):
    fr = rng.standard_normal((2, frames, 400)).astype(np.float32)
    got = T.overlap_add(torch.from_numpy(fr)).numpy()
    ref = np.asarray(J.overlap_add(jnp.asarray(fr)))
    assert got.shape == ref.shape == (2, 160 * (frames - 1) + 400)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("L", [400, 4037, 16000])
def test_istft_roundtrip_matches_jax(rng, L):
    x = _sig(rng, (2, L))
    re, im = J.stft(jnp.asarray(x))
    re, im = np.array(re), np.array(im)
    got = T.istft(torch.from_numpy(re), torch.from_numpy(im)).numpy()
    ref = np.asarray(J.istft(jnp.asarray(re), jnp.asarray(im)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(x).max())
