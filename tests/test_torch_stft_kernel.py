"""The fused spectrogram of the port (nhans_tpu_torch.ops.stft_cuda).

On the CPU: its plain version against the JAX package's Pallas kernel in
interpret mode, at the bars of tests/test_pallas_ops.py (log-magnitude
atol 5e-3, re/im within 5e-3 x max|re|); the wrapper's dispatch and input
checks; and a numpy emulation of the CUDA kernel's schedule (frame tiling,
packing, the three FFT stages with their twiddle indices, the real split,
the real bins 0 and 200 summed in float64), which pins its index
arithmetic where no card can run it.
On the card (marker ``gpu``): the kernel against the plain version taken
in float64 and in float32.  The
machine with the card has no JAX, so this module imports JAX only inside
the test that needs it, and the card runs it with
``python -m pytest --noconftest -m gpu tests/test_torch_stft_kernel.py``
(tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from nhans_tpu_torch.dsp import spectral as sp
from nhans_tpu_torch.ops import stft_cuda

LM_ATOL = 5e-3
REIM_RTOL = 5e-3  # x max|re|
# re/im against the plain version in float64: the float32 FFT's rounding
REIM_EXACT_RTOL = 1e-5  # x max|re|


def _x(rng, shape, scale=100.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("L", [720, 16000])
@pytest.mark.parametrize("with_reim", [False, True])
def test_plain_matches_pallas_interpret(rng, L, with_reim):
    import jax.numpy as jnp
    from nhans_tpu.ops.stft_pallas import pallas_log_spectrogram

    x = _x(rng, (2, L))
    got = stft_cuda.log_spectrogram_plain(torch.from_numpy(x), with_reim)
    ref = pallas_log_spectrogram(jnp.asarray(x), interpret=True,
                                 with_reim=with_reim)
    if not with_reim:
        got, ref = (got,), (ref,)
    got = [g.numpy() for g in got]
    ref = [np.asarray(r) for r in ref]
    assert got[0].shape == ref[0].shape == (2, sp.num_frames(L), 201)
    np.testing.assert_allclose(got[0], ref[0], atol=LM_ATOL)
    if with_reim:
        scale = np.abs(ref[1]).max()
        np.testing.assert_allclose(got[1], ref[1], atol=REIM_RTOL * scale)
        np.testing.assert_allclose(got[2], ref[2], atol=REIM_RTOL * scale)


def test_wrapper_sends_cpu_tensors_to_plain(rng):
    x = torch.from_numpy(_x(rng, (3, 5000)))
    before = stft_cuda.log_spectrogram_kernel.launches
    lm = stft_cuda.log_spectrogram_kernel(x)
    lm3 = stft_cuda.log_spectrogram_kernel(x, with_reim=True)
    assert stft_cuda.log_spectrogram_kernel.launches == before
    torch.testing.assert_close(lm, stft_cuda.log_spectrogram_plain(x),
                               rtol=0, atol=0)
    for a, b in zip(lm3, stft_cuda.log_spectrogram_plain(x, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_checks_its_input(rng):
    x = torch.from_numpy(_x(rng, (2, 4000)))
    for bad in (x.double(), x[0], x[None], x[:, ::2]):
        with pytest.raises(ValueError):
            stft_cuda.log_spectrogram_kernel(bad)
    empty = stft_cuda.log_spectrogram_kernel(x[:, :399].contiguous(),
                                             with_reim=True)
    assert all(t.shape == (2, 0, 201) for t in empty)


# The CUDA kernel's schedule in float32 numpy: 4 frames per block, the
# span staged with zero fill past the row, each frame packed as 200 complex
# values, three Stockham stages (radix R, stride Ns) with twiddles from the
# cos table, the real split by pairs (k, 200 - k) with the real bins 0 and
# 200 summed in float64, and the masked store of the ragged last tile.
TILE, N = stft_cuda.TILE_FRAMES, 200
STAGES = ((5, 1), (5, 5), (8, 25))  # (radix, Ns), 200 = 5 * 5 * 8
_C1, _C2 = np.float32(np.cos(2 * np.pi / 5)), np.float32(np.cos(4 * np.pi / 5))
_S1, _S2 = np.float32(np.sin(2 * np.pi / 5)), np.float32(np.sin(4 * np.pi / 5))
_H = np.float32(np.sqrt(0.5))


def _cos500():
    """The kernel's shared cos table: cos(2*pi*m/400), m in [0, 500)."""
    cos_tab = stft_cuda._tables(torch.device("cpu")).numpy()[:400]
    return cos_tab[np.arange(500) % 400]


def _twiddle(cosw, m):
    """exp(-2*pi*i*m/400) as the kernel reads it: (cos[m], cos[m + 100])."""
    return (cosw[m] + 1j * cosw[m + 100]).astype(np.complex64)


def _mi(u):
    """-i * u"""
    return (u.imag - 1j * u.real).astype(np.complex64)


def _dft5(a):
    a0, a1, a2, a3, a4 = (a[..., i] for i in range(5))
    t1, t2, t3, t4 = a1 + a4, a2 + a3, a1 - a4, a2 - a3
    b1 = a0 + _C1 * t1 + _C2 * t2
    b2 = a0 + _C2 * t1 + _C1 * t2
    d1 = _mi(_S1 * t3 + _S2 * t4)
    d2 = _mi(_S2 * t3 - _S1 * t4)
    return np.stack([a0 + (t1 + t2), b1 + d1, b2 + d2, b2 - d2, b1 - d1], -1)


def _dft4(b):
    p0, p1 = b[..., 0] + b[..., 2], b[..., 0] - b[..., 2]
    p2, p3 = b[..., 1] + b[..., 3], _mi(b[..., 1] - b[..., 3])
    return np.stack([p0 + p2, p1 + p3, p0 - p2, p1 - p3], -1)


def _dft8(a):
    u, v = a[..., :4] + a[..., 4:], a[..., :4] - a[..., 4:]
    v1, v3 = v[..., 1], v[..., 3]
    v = np.stack([v[..., 0],
                  _H * (v1.real + v1.imag) + 1j * (_H * (v1.imag - v1.real)),
                  _mi(v[..., 2]),
                  _H * (v3.imag - v3.real) - 1j * (_H * (v3.real + v3.imag))],
                 -1).astype(np.complex64)
    out = np.empty_like(a)
    out[..., 0::2], out[..., 1::2] = _dft4(u), _dft4(v)
    return out


def _stage(z, R, Ns, cosw):
    """One Stockham stage over the last axis (200): butterfly j reads
    z[j + r * 200 / R], twiddles by exp(-2*pi*i*(j % Ns)*r/(Ns*R)) for
    r >= 1, and writes to (j // Ns) * Ns * R + j % Ns + r * Ns."""
    j = np.arange(N // R)[:, None]
    r = np.arange(R)[None, :]
    v = z[..., j + r * (N // R)]
    tw = _twiddle(cosw, (j % Ns) * r * (400 // (Ns * R)))
    v = np.concatenate([v[..., :1], v[..., 1:] * tw[:, 1:]], -1)
    out = np.empty_like(z)
    out[..., (j // Ns) * Ns * R + j % Ns + r * Ns] = {5: _dft5, 8: _dft8}[R](v)
    return out


def _emulate_kernel(x: np.ndarray):
    tables = stft_cuda._tables(torch.device("cpu")).numpy()
    win, cosw, win64 = tables[400:800], _cos500(), tables[800:].view(np.float64)
    B, L = x.shape
    F = sp.num_frames(L)
    tiles = -(-F // TILE)
    span_len = (TILE - 1) * 160 + 400
    # [B, tiles, span]: block (row, tile) stages samples 640 * tile + [0, 880)
    s = 160 * TILE * np.arange(tiles)[:, None] + np.arange(span_len)[None, :]
    span = np.where(s < L, x[:, np.minimum(s, L - 1)], np.float32(0))
    # [B, tiles, 4, 400] frames, packed as [B, tiles, 4, 200] complex
    frames = span[..., 160 * np.arange(TILE)[:, None] + np.arange(400)[None, :]]
    xw = frames * win
    z = (xw[..., 0::2] + 1j * xw[..., 1::2]).astype(np.complex64)
    for R, Ns in STAGES:
        z = _stage(z, R, Ns, cosw)
    # real split by pairs (k, 200 - k)
    k = np.arange(N // 2 + 1)
    a = z[..., k]
    bc = np.conj(z[..., (N - k) % N])
    e = (np.float32(0.5) * (a + bc)).astype(np.complex64)
    pk = (np.float32(0.5) * (a - bc)) * _twiddle(cosw, k)
    X = np.empty((*z.shape[:-1], 201), np.complex64)
    X[..., k] = e - 1j * pk
    X[..., N - k[:-1]] = (np.conj(e) - 1j * np.conj(pk))[..., :-1]
    # the real bins: float64 sum and alternating sum, rounded once
    xw64 = frames.astype(np.float64) * win64
    X[..., 0] = xw64.sum(-1).astype(np.float32)
    X[..., N] = (xw64 * (-1.0) ** np.arange(400)).sum(-1).astype(np.float32)
    # masked store: frames past F are dropped
    X = X.reshape(B, tiles * TILE, 201)[:, :F]
    re, im = X.real.copy(), X.imag.copy()
    lm = np.log(np.sqrt(re * re + im * im) + np.float32(1e-5))
    return lm, re, im


@pytest.mark.parametrize("L", [400, 720, 400 + 160 * 129 + 37])
def test_kernel_fft_emulation_matches_plain(rng, L):
    x = _x(rng, (2, L))
    lm, re, im = _emulate_kernel(x)
    plm, pre, pim = (t.numpy() for t in
                     stft_cuda.log_spectrogram_plain(torch.from_numpy(x), True))
    assert lm.shape == plm.shape and lm.dtype == np.float32
    np.testing.assert_allclose(lm, plm, atol=LM_ATOL)
    # re/im: 1e-5 x max|re|, far inside REIM_RTOL: the float32 FFT's
    # rounding, not a wrong index, is all that may differ
    scale = np.abs(pre).max()
    np.testing.assert_allclose(re, pre, atol=1e-5 * scale)
    np.testing.assert_allclose(im, pim, atol=1e-5 * scale)


def test_kernel_emulation_against_float64_at_many_frames(rng):
    """At 16 rows of 10 s (3.2M bins) some |X[0]| or |X[200]| of noise comes
    within a few 1e-5 of zero, where a float32 FFT's error of about
    1e-7 x max|X| moves log(|X| + 1e-5) by 1e-2.  The kernel sums those
    two bins in float64, so it stays within LM_ATOL of the plain version
    taken in float64 at every bin, and its re/im within 1e-5 x max|re|."""
    x = _x(rng, (16, 160000))
    lm, re, im = _emulate_kernel(x)
    elm, ere, eim = (t.numpy() for t in stft_cuda.log_spectrogram_plain(
        torch.from_numpy(x).double(), True))
    np.testing.assert_allclose(lm, elm, rtol=0, atol=LM_ATOL)
    scale = np.abs(ere).max()
    np.testing.assert_allclose(re, ere, rtol=0, atol=REIM_EXACT_RTOL * scale)
    np.testing.assert_allclose(im, eim, rtol=0, atol=REIM_EXACT_RTOL * scale)
    # the real bins are the float64 values rounded once: half an ulp
    for k in (0, N):
        np.testing.assert_allclose(re[..., k], ere[..., k], rtol=2 ** -24,
                                   atol=0)
        assert not im[..., k].any()


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_kernel_fft_stages_match_numpy_fft(rng, stages):
    """After the stages whose radices multiply to P, the Stockham buffer
    holds, at b * P + k, bin k of the P-point DFT of z[b + (200 / P) n]."""
    z = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(np.complex64)
    got, P = z, 1
    for R, Ns in STAGES[:stages]:
        got = _stage(got, R, Ns, _cos500())
        P *= R
    b = np.arange(N // P)[:, None]
    ref = np.fft.fft(z.astype(np.complex128)[b + (N // P) * np.arange(P)], axis=-1)
    np.testing.assert_allclose(got.reshape(N // P, P), ref,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 160000), (8, 160000), (64, 160000),
                                   (16, 32240), (3, 4000 + 77),
                                   (2, 400 + 160 * 20), (2, 399), (1, 400),
                                   (5, 16000 + 2)])
@pytest.mark.parametrize("with_reim", [False, True])
def test_kernel_matches_plain_on_card(shape, with_reim):
    """The kernel within LM_ATOL (log-magnitude) and 1e-5 x max|re| (re/im)
    of the plain version taken in float64, and within the bars of the
    float32 plain version, except at bins where the float32 plain version
    is the farther of the two from float64 (the real bins of
    [64, 160000]: test_kernel_emulation_against_float64_at_many_frames)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(_x(rng, shape, 3000.0)).cuda()
    got = stft_cuda.log_spectrogram_kernel(x, with_reim)
    ref = stft_cuda.log_spectrogram_plain(x, True)
    exact = stft_cuda.log_spectrogram_plain(x.double(), True)
    torch.cuda.synchronize()
    if not with_reim:
        got = (got,)
    assert got[0].shape == ref[0].shape
    torch.testing.assert_close(got[0].double(), exact[0], rtol=0,
                               atol=LM_ATOL)
    off = (got[0] - ref[0]).abs() > LM_ATOL
    plain_err = (ref[0].double() - exact[0]).abs()[off]
    assert (plain_err > (got[0].double() - exact[0]).abs()[off]).all()
    if with_reim and ref[1].numel():
        scale = exact[1].abs().max().item()
        for g, r, e in zip(got[1:], ref[1:], exact[1:]):
            torch.testing.assert_close(g.double(), e, rtol=0,
                                       atol=REIM_EXACT_RTOL * scale)
            torch.testing.assert_close(g, r, rtol=0, atol=REIM_RTOL * scale)
