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
from nhans_tpu_torch.infer import enhance as enhance_mod
from nhans_tpu_torch.infer.enhance import (Enhancer, context_samples,
                                           kept_windows, window_residuals)
from nhans_tpu_torch.nn.model import NHANSNet
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


# ---------------------------------------------------------------------- #
# the tower computes only the windows that reach the reconstruction
# ---------------------------------------------------------------------- #

def _narrow_model(seed=0):
    """The narrow model of the span tests with every weight drawn from the
    seed (its init zeroes the last layer, which would make every residual
    0), in eval mode."""
    from tests.test_torch_spans import _small

    cfg = _small()
    g = torch.Generator().manual_seed(seed)
    state = {k: (torch.rand(v.shape, generator=g) + 0.5
                 if k.endswith("pop_variance")
                 else torch.randn(v.shape, generator=g) * 0.2)
             for k, v in NHANSNet(cfg.model).state_dict().items()}
    model = NHANSNet(cfg.model)
    model.load_state_dict(state)
    return cfg, state, model.eval()


def _count_windows(model, monkeypatch):
    """The windows of each main-tower call of ``model``, in order (the
    context encoder's calls pass no windows)."""
    calls = []
    forward = model.forward

    def counting(mixed, *args, **kwargs):
        if mixed is not None:
            calls.append(mixed.shape[0])
        return forward(mixed, *args, **kwargs)

    monkeypatch.setattr(model, "forward", counting)
    return calls


@pytest.mark.parametrize("window_chunk,keep_until", [
    (7, (20, 20, 16)),      # several chunks of 7 and a tail of 3
    (64, (20, 20, 16)),     # one chunk
    (7, (0, 0, 0)),         # no window: the model is not called
], ids=["chunks_and_tail", "one_chunk", "empty"])
def test_window_residuals_at_kept_windows(window_chunk, keep_until,
                                          monkeypatch):
    """Rows of 20 frames (full), 13 frames (ragged) and frames 4 to 15:
    the residuals with ``keep`` equal the full computation's at the kept
    windows and are exactly 0 elsewhere; the model sees only those."""
    cfg, _, model = _narrow_model()
    a = cfg.audio
    B, F = 3, 20
    g = torch.Generator().manual_seed(1)
    logmag = torch.randn((B, F, cfg.model.num_features), generator=g)
    emb_a, emb_b = (torch.randn((B, cfg.model.embedding_dim), generator=g)
                    for _ in range(2))
    n_mixed = [a.frame_length + (n - 1) * a.frame_step for n in (20, 13, 20)]
    ints = np.array([[n, 0, 0, k0, k1] for n, k0, k1
                     in zip(n_mixed, (0, 0, 4), keep_until)], np.int32)
    keep = kept_windows(ints, F, a.frame_length, a.frame_step)
    mask = np.zeros((B, F), bool)
    mask.reshape(-1)[keep] = True
    assert mask.sum() == sum(max(0, min(n, k1) - k0) for n, k0, k1
                             in zip((20, 13, 20), (0, 0, 4), keep_until))
    with torch.no_grad():
        full = window_residuals(model, logmag, emb_a, emb_b, 64).numpy()
        calls = _count_windows(model, monkeypatch)
        got = window_residuals(model, logmag, emb_a, emb_b, window_chunk,
                               keep=torch.from_numpy(keep)).numpy()
    assert np.abs(full[mask]).max(initial=1.0) > 1e-2  # not a zero model
    np.testing.assert_allclose(got[mask], full[mask], atol=1e-6, rtol=0)
    assert not got[~mask].any()
    n = len(keep)
    assert calls == [window_chunk] * (n // window_chunk) + (
        [n % window_chunk] if n % window_chunk else [])


def test_a_batch_of_three_padded_to_four_computes_its_89_windows(
        monkeypatch):
    """Lengths 4800, 7200 and 3200 samples (28, 43 and 18 frames) on the
    0.5 s bucket (48 frames), padded to 4 rows: the tower runs on the 89
    real windows alone, in chunks of 64, and the outputs equal those of
    the tower run on all 4 x 48."""
    cfg, state, _ = _narrow_model()
    enh = Enhancer(cfg, state, window_chunk=64,
                   buckets_seconds=(0.5, 1.0), device="cpu")
    rng = np.random.default_rng(0)
    mixed = [rng.standard_normal(n) * 2000 for n in (4800, 7200, 3200)]
    pos, neg = rng.standard_normal(3000) * 700, rng.standard_normal(9000) * 1500
    calls = _count_windows(enh.model, monkeypatch)
    got = enh.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    assert calls == [64, 25]
    monkeypatch.setattr(enhance_mod, "window_residuals",
                        lambda *args, keep: window_residuals(*args))
    calls.clear()
    every = enh.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    assert calls == [64, 64, 64]
    assert np.abs(got["removed"][1]).max() > 0.1  # the tower did something
    for key in ("denoised", "mixed_processed", "removed"):
        for g_, e in zip(got[key], every[key]):
            np.testing.assert_allclose(g_, e, atol=1e-5, rtol=0, err_msg=key)
    np.testing.assert_allclose(got["snr_est"], every["snr_est"], rtol=1e-5)
    np.testing.assert_allclose(got["cap_clip_frac"], every["cap_clip_frac"],
                               atol=1e-6, rtol=0)


def test_a_shard_of_pad_rows_computes_no_window(monkeypatch):
    """One utterance over two devices: the second shard holds only the pad
    row, so its tower runs on no window, and the result is the one-device
    result."""
    cfg, state, _ = _narrow_model()
    kw = dict(window_chunk=64, buckets_seconds=(0.5,))
    one = Enhancer(cfg, state, device="cpu", **kw)
    two = Enhancer(cfg, state, devices=["cpu", "cpu"], **kw)
    (mixed,), pos, neg = _signals(12, [0.4])
    calls = [_count_windows(m, monkeypatch) for m in two.models]
    got = two.enhance(mixed, pos, neg)
    assert calls == [[cfg.audio.num_frames(len(mixed))], []]
    ref = one.enhance(mixed, pos, neg)
    for key in ("denoised", "mixed_processed", "removed"):
        np.testing.assert_allclose(got[key], ref[key], atol=1e-6, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(got["snr_est"], ref["snr_est"], rtol=1e-6)
