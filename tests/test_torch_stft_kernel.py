"""The fused spectrogram of the port (nhans_tpu_torch.ops.stft_cuda).

On the CPU: its plain version against the JAX package's Pallas kernel in
interpret mode, at the bars of tests/test_pallas_ops.py (log-magnitude
atol 5e-3, re/im within 5e-3 x max|re|); the wrapper's dispatch and input
checks; and a numpy emulation of the CUDA kernel's tiling and basis
rebuild, which pins its index arithmetic where no card can run it.
On the card (marker ``gpu``): the kernel against the plain version.  The
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


def _emulate_kernel(x: np.ndarray):
    """The CUDA kernel's arithmetic, block by block, in float32 numpy:
    span staging with zero fill past the row, the basis rebuilt from the
    cos table and the window with the sine as a quarter-turn shift, and
    the masked stores of the ragged tile and of bins past 200."""
    TF, TB, FL, FS, BINS = 64, 32, 400, 160, 201
    tables = stft_cuda._tables(torch.device("cpu")).numpy()
    cos_tab, win = tables[:FL], tables[FL:]
    B, L = x.shape
    F = sp.num_frames(L)
    re = np.full((B, F, BINS), np.nan, np.float32)
    im = np.full_like(re, np.nan)
    n = np.arange(FL)
    span_len = (TF - 1) * FS + FL
    for row in range(B):
        for f0 in range(0, F, TF):
            s = f0 * FS + np.arange(span_len)
            span = np.where(s < L, x[row, np.minimum(s, L - 1)], 0.0)
            frames = span[(np.arange(TF) * FS)[:, None] + n[None, :]]
            for k0 in range(0, BINS, TB):
                k = k0 + np.arange(TB)
                m = (n[:, None] * k[None, :]) % FL
                bc = win[:, None] * cos_tab[m]
                bs = win[:, None] * cos_tab[(m + FL // 4) % FL]
                r = (frames @ bc).astype(np.float32)
                q = (frames @ bs).astype(np.float32)
                nf, nk = min(TF, F - f0), min(TB, BINS - k0)
                if nk <= 0:
                    continue
                re[row, f0:f0 + nf, k0:k0 + nk] = r[:nf, :nk]
                im[row, f0:f0 + nf, k0:k0 + nk] = q[:nf, :nk]
    lm = np.log(np.sqrt(re * re + im * im) + np.float32(1e-5))
    return lm, re, im


@pytest.mark.parametrize("L", [400, 720, 400 + 160 * 129 + 37])
def test_kernel_tiling_emulation_matches_plain(rng, L):
    x = _x(rng, (2, L))
    lm, re, im = _emulate_kernel(x)
    plm, pre, pim = (t.numpy() for t in
                     stft_cuda.log_spectrogram_plain(torch.from_numpy(x), True))
    assert not np.isnan(lm).any()
    np.testing.assert_allclose(lm, plm, atol=LM_ATOL)
    scale = np.abs(pre).max()
    np.testing.assert_allclose(re, pre, atol=1e-5 * scale)
    np.testing.assert_allclose(im, pim, atol=1e-5 * scale)


def test_rebuilt_basis_within_an_ulp_of_float64_basis():
    """The kernel's basis entry float(w) * float(cos) against the plain
    version's float32(w * cos) taken in float64: at most 2 float32 ulps
    apart, entries near zero aside (absolute 1e-7)."""
    tables = stft_cuda._tables(torch.device("cpu")).numpy()
    cos_tab, win = tables[:400], tables[400:]
    n = np.arange(400)[:, None]
    k = np.arange(201)[None, :]
    m = (n * k) % 400
    rebuilt_c = win[:, None] * cos_tab[m]
    rebuilt_s = win[:, None] * cos_tab[(m + 100) % 400]
    ref_c, ref_s = (b.astype(np.float32) for b in sp._dft_bases_np(400, 201))
    for got, ref in ((rebuilt_c, ref_c), (rebuilt_s, ref_s)):
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        err = np.abs(got - ref)
        assert np.all((err <= 2 * ulp) | (err <= 1e-7))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 160000), (8, 160000), (16, 32240),
                                   (3, 4000 + 77), (2, 400 + 160 * 20),
                                   (2, 399)])
@pytest.mark.parametrize("with_reim", [False, True])
def test_kernel_matches_plain_on_card(shape, with_reim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(_x(rng, shape, 3000.0)).cuda()
    got = stft_cuda.log_spectrogram_kernel(x, with_reim)
    ref = stft_cuda.log_spectrogram_plain(x, with_reim)
    torch.cuda.synchronize()
    if not with_reim:
        got, ref = (got,), (ref,)
    assert got[0].shape == ref[0].shape
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=LM_ATOL)
    if with_reim and ref[1].numel():
        scale = ref[1].abs().max().item()
        for g, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(g, r, rtol=0, atol=REIM_RTOL * scale)
