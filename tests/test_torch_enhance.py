"""The port's Enhancer (device="cpu") against the JAX package's
Enhancer(out_wire="float32"), both with the shipped weights, the same
half-second bucket and small window chunks.

Tolerances: waveforms (normalised to a peak of about 1) within 1e-4
absolute and snr_est within 1e-4 relative.  Both run float32; they differ
in the summation order of the convolutions (oneDNN against XLA), which
moves the waveforms by about 5e-7."""

import numpy as np
import pytest
import torch

from nhans_tpu.config import Config as JConfig
from nhans_tpu.infer.enhance import Enhancer as JEnhancer
from nhans_tpu_torch.compat.weights import load_npz
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.infer.enhance import Enhancer, context_samples
from tests.make_torch_golden import DENOISER_NPZ, SEPARATOR_NPZ, jax_variables

WAVE_ATOL = 1e-4
SNR_RTOL = 1e-4
KW = dict(window_chunk=64, buckets_seconds=(0.5,))


@pytest.fixture(scope="module")
def jax_denoiser():
    return JEnhancer(JConfig.denoiser(), jax_variables(DENOISER_NPZ),
                     out_wire="float32", **KW)


@pytest.fixture(scope="module")
def port_denoiser():
    return Enhancer(Config.denoiser(), load_npz(DENOISER_NPZ), device="cpu",
                    **KW)


def _signals(seed, seconds):
    """Seeded int16-scale (mixed..., pos, neg): a short positive context
    (tiled to 200 frames) and a long negative one (cut)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(max(seconds) * 16000)) / 16000.0
    tone = np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 660 * t)
    mixed = [4000.0 * tone[:int(s * 16000)]
             + rng.standard_normal(int(s * 16000)) * 1500.0 for s in seconds]
    pos = rng.standard_normal(3000) * 700.0
    neg = rng.standard_normal(40000) * 1500.0
    return mixed, pos, neg


def _assert_same(got, ref):
    for key in ("denoised", "mixed_processed", "removed"):
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.shape == r.shape, key
        np.testing.assert_allclose(g, r, atol=WAVE_ATOL, err_msg=key)
    np.testing.assert_allclose(got["snr_est"], ref["snr_est"], rtol=SNR_RTOL)
    np.testing.assert_allclose(got["cap_clip_frac"], ref["cap_clip_frac"],
                               atol=1e-6)


def test_enhance_on_a_bucket_longer_than_the_utterance(jax_denoiser,
                                                       port_denoiser):
    """0.3 s on the 0.5 s bucket: the windows of the last 17 frames read
    frames of zero audio, log(1e-5), as in the JAX package."""
    (mixed,), pos, neg = _signals(1, [0.3])
    mixed = np.concatenate([mixed, [123.0] * 37])  # not whole frames
    ref = jax_denoiser.enhance(mixed, pos, neg)
    got = port_denoiser.enhance(mixed, pos, neg)
    n = port_denoiser.cfg.audio.trim_to_whole_frames(len(mixed))
    assert len(got["denoised"]) == n
    _assert_same(got, ref)
    # on a bucket of the utterance's own length the tail windows read
    # zeros instead, and the last frames come out otherwise
    exact = Enhancer(Config.denoiser(), port_denoiser.model.state_dict(),
                     device="cpu", window_chunk=64,
                     buckets_seconds=(n / 16000.0,)).enhance(mixed, pos, neg)
    tail = slice(-160 * 17, None)
    assert np.abs(exact["denoised"][tail]
                  - ref["denoised"][tail]).max() > 10 * WAVE_ATOL


def test_enhance_batch_with_ragged_lengths(jax_denoiser, port_denoiser):
    mixed, pos, neg = _signals(2, [0.2, 0.45, 0.33])
    ref = jax_denoiser.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    got = port_denoiser.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    for i in range(3):
        _assert_same({k: v[i] for k, v in got.items()},
                     {k: v[i] for k, v in ref.items()})


def test_enhance_long_matches_unsegmented(port_denoiser):
    (mixed,), pos, neg = _signals(3, [0.3])
    whole = port_denoiser.enhance(mixed, pos, neg)
    seg = port_denoiser.enhance_long(mixed, pos, neg, segment_seconds=0.5,
                                     segment_batch=2)
    for key in ("denoised", "mixed_processed", "removed"):
        assert len(seg[key]) == len(whole[key])
        np.testing.assert_allclose(seg[key], whole[key], atol=2e-6)
    np.testing.assert_allclose(seg["snr_est"], whole["snr_est"], rtol=1e-3)


def test_enhance_long_tail_at_an_exact_bucket_follows_jax():
    """An utterance that fills its bucket exactly: the unsegmented call's
    last 17 windows read the zero padding of the log-magnitude, while
    enhance_long's last segment sits on a longer bucket and reads frames
    of zero audio, log(1e-5).  The JAX package's two paths differ there;
    the port reproduces both, and they agree before that tail."""
    kw = dict(window_chunk=64, buckets_seconds=(0.295, 0.5))  # 4720 samples
    (mixed,), pos, neg = _signals(7, [0.295])
    jax_enh = JEnhancer(JConfig.denoiser(), jax_variables(DENOISER_NPZ),
                        out_wire="float32", **kw)
    port = Enhancer(Config.denoiser(), load_npz(DENOISER_NPZ), device="cpu",
                    **kw)
    long_kw = dict(segment_seconds=0.5, segment_batch=2)
    j_whole, j_long = (jax_enh.enhance(mixed, pos, neg),
                       jax_enh.enhance_long(mixed, pos, neg, **long_kw))
    p_whole, p_long = (port.enhance(mixed, pos, neg),
                       port.enhance_long(mixed, pos, neg, **long_kw))
    _assert_same(p_whole, j_whole)
    _assert_same(dict(p_long, cap_clip_frac=0.0),
                 dict(j_long, cap_clip_frac=0.0))
    head = 160 * (port.cfg.audio.num_frames(len(mixed)) - 17)
    np.testing.assert_allclose(p_long["denoised"][:head],
                               p_whole["denoised"][:head], atol=2e-6)
    for whole, long in ((j_whole, j_long), (p_whole, p_long)):
        assert np.abs(long["denoised"][head:]
                      - whole["denoised"][head:]).max() > 10 * WAVE_ATOL


def test_enhance_stream_and_context_cache(port_denoiser):
    mixed, pos, neg = _signals(4, [0.25, 0.4])
    batches = [([m], [pos], [neg]) for m in mixed]
    port_denoiser._ctx_cache.clear()
    streamed = list(port_denoiser.enhance_stream(iter(batches), depth=2))
    assert len(port_denoiser._ctx_cache) == 1   # same contexts: encoded once
    for got, batch in zip(streamed, batches):
        want = port_denoiser.enhance_batch(*batch)
        np.testing.assert_array_equal(got["denoised"][0], want["denoised"][0])


def test_compensate_matches_jax(rng):
    den, rem = rng.standard_normal(500), rng.standard_normal(500)
    for kw in (dict(compensate=0.3), dict(ac=True), dict()):
        np.testing.assert_allclose(
            Enhancer.compensate(den, rem, 7.0, **kw),
            JEnhancer.compensate(den, rem, 7.0, **kw), rtol=0, atol=0)


def test_amplification_cap_clips_like_jax(capsys):
    """Rig the head's bias to +12 nats on bin 0: the cap bites, the
    clipped fraction and the waveforms agree, and the NOTE is printed."""
    jv = jax_variables(DENOISER_NPZ)
    jv["params"]["last_dense"]["b"][0] = 12.0
    state = load_npz(DENOISER_NPZ)
    state["last_dense.b"][0] = 12.0
    (mixed,), pos, neg = _signals(5, [0.3])
    ref = JEnhancer(JConfig.denoiser(), jv, out_wire="float32",
                    **KW).enhance(mixed, pos, neg)
    capsys.readouterr()
    got = Enhancer(Config.denoiser(), state, device="cpu",
                   **KW).enhance(mixed, pos, neg)
    assert "recon_residual_cap clipped" in capsys.readouterr().out
    assert got["cap_clip_frac"] > 1e-3
    _assert_same(got, ref)


def test_separator_matches_jax_in_its_slot_order():
    """The separator's first context is the interference speaker and the
    second the target speaker; swapping them changes the output."""
    (mixed,), target, interference = _signals(6, [0.3])
    ref = JEnhancer(JConfig.separator(), jax_variables(SEPARATOR_NPZ),
                    out_wire="float32", **KW).enhance(mixed, interference,
                                                      target)
    port = Enhancer(Config.separator(), load_npz(SEPARATOR_NPZ),
                    device="cpu", **KW)
    got = port.enhance(mixed, interference, target)
    _assert_same(got, ref)
    swapped = port.enhance(mixed, target, interference)
    assert np.abs(swapped["denoised"] - got["denoised"]).max() > 1e-3


def test_context_samples_and_device_choice():
    assert context_samples(Config.denoiser()) == 32240
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Enhancer(Config.denoiser(), load_npz(DENOISER_NPZ))


def test_tf32_is_off_only_while_serving(port_denoiser, monkeypatch):
    """The Enhancer turns TF32 off around its own device work and leaves
    the process's settings as they were."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    seen = []
    forward = port_denoiser.model.forward

    def spy(*args, **kwargs):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        return forward(*args, **kwargs)

    monkeypatch.setattr(port_denoiser.model, "forward", spy)
    port_denoiser._ctx_cache.clear()
    (mixed,), pos, neg = _signals(11, [0.3])
    port_denoiser.enhance(mixed, pos, neg)
    assert len(seen) >= 2  # the contexts and the windows
    assert set(seen) == {(False, False)}
    assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
