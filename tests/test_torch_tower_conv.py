"""The main tower's convolution (nhans_tpu_torch.ops.tower_conv) and the
inference forward of CondResBlock that uses it.

On the CPU: the plain version equals ``Conv.forward`` bit for bit at every
stage's (k, stride) with reduced channels, with and without bias, in the
native and the lane-padded geometry; the wrapper sends a CPU tensor to the
plain version and refuses what the kernel does not take; the fused block
routes conv1 and conv2 through it in float32 inference only and still
equals the modules; and a numpy emulation of the CUDA kernel's indexing
(each thread's copies into the tiles, the tile of each block, the staged
store) gives the float64 convolution at every tile shape it chooses.  On
the card (marker ``gpu``): the kernel at the shipped tower's 16
convolutions within the float32 sum's bound of the float64 convolution
and no farther from it than twice cuDNN's float32 result, non-finite
values as in ``F.conv2d``, 16 launches per tower forward, the lane-padded
tower equal to the native one.  The machine
with the card has no JAX: this module imports none, and the card runs it
with ``python -m pytest --noconftest -m gpu tests/test_torch_tower_conv.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nhans_tpu_torch.config import Config, ModelConfig
from nhans_tpu_torch.nn import model as nn_model
from nhans_tpu_torch.nn.blocks import Conv, same_pads
from nhans_tpu_torch.nn.model import NHANSNet
from nhans_tpu_torch.ops import tower_conv as tc

# (k, stride, H, W) of each stage's convolutions at full width, and the
# lane-padded width the tower gives each stage's input
STAGES = [(4, 1, 35, 201), (4, 2, 35, 201), (4, 1, 18, 101),
          (3, 2, 18, 101), (3, 1, 9, 51), (3, 2, 9, 51), (3, 1, 5, 26)]
PADDED = {201: 256, 101: 128, 51: 64, 26: 32}


def _conv(cin, cout, k, s, bias, seed=0):
    torch.manual_seed(seed)
    conv = Conv(cin, cout, (k, k), (s, s), use_bias=bias)
    with torch.no_grad():
        for p in conv.parameters():
            p.normal_(0.0, 0.3)
    return conv


@pytest.mark.parametrize("k,s,H,W", STAGES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_plain_is_conv_forward_bit_for_bit(k, s, H, W, bias, padded):
    """Reduced channels at each stage's (k, stride) and size; in the
    lane-padded geometry the input is wider than its true width, which
    Conv.forward pads for (its dead columns hold zeros there)."""
    conv = _conv(3, 8, k, s, bias)
    g = torch.Generator().manual_seed(k * s * W)
    width = PADDED[W] if padded else W
    x = torch.randn(2, 3, H, width, generator=g)
    x[..., W:] = 0.0
    fs = W if padded else None
    pads = conv.pads(x, fs)
    ref = conv(x, fs)
    got = tc.tower_conv_plain(x, conv.w, conv.b, conv.strides, pads)
    assert torch.equal(got, ref)
    assert torch.equal(tc.tower_conv(x, conv.w, conv.b, conv.strides, pads),
                       ref)
    Ho, Wo = ref.shape[2:]
    assert (Ho, Wo) == (tc.out_size(H, k, s, pads[2], pads[3]),
                        tc.out_size(width, k, s, pads[0], pads[1]))
    assert Ho == same_pads(H, k, s)[2]
    assert Wo >= same_pads(W, k, s)[2]


def test_wrapper_sends_cpu_tensors_to_plain(monkeypatch):
    def no_kernel():
        raise AssertionError("the kernel was asked for a CPU tensor")

    monkeypatch.setattr(tc, "_kernel_fn", no_kernel)
    conv = _conv(4, 8, 3, 2, True)
    x = torch.randn(3, 4, 9, 51)
    before = tc.tower_conv.launches
    got = tc.tower_conv(x, conv.w, conv.b, conv.strides, conv.pads(x))
    assert tc.tower_conv.launches == before
    assert torch.equal(got, conv(x))


def test_checks_refuse_what_the_kernel_does_not_take():
    conv = _conv(4, 8, 4, 1, True)
    x = torch.randn(2, 4, 9, 13)
    w, b, st, pads = conv.w.detach(), conv.b.detach(), (1, 1), conv.pads(x)
    bad = [
        (x.to(torch.bfloat16), w, b, st, pads),            # bfloat16
        (x, w.to(torch.bfloat16), b, st, pads),
        (x, w, b.to(torch.bfloat16), st, pads),
        (x.double(), w, b, st, pads),
        (x.transpose(2, 3), w, b, st, pads),                # not contiguous
        (x, w.transpose(2, 3), b, st, pads),
        (x, w, torch.randn(16)[::2], st, pads),
        (x[0], w, b, st, pads),                             # shapes
        (x, w[:, :3].contiguous(), b, st, pads),
        (x, w[..., :3].contiguous(), b, st, pads),          # 4 x 3
        (x, torch.randn(8, 4, 5, 5), b, st, pads),          # k = 5
        (x, w, b[:4], st, pads),
        (x, w, b, (0, 1), pads),
        (x, w, b, st, (-1, 2, 1, 2)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tc.tower_conv(*args)


_SMALL = dict(context_frames=40, embedding_dim=12, pos_embed_hidden=10,
              main_blocks=((4, 1, 8), (4, 2, 16), (3, 2, 32), (3, 1, 32)),
              context_blocks=(((8, 4), (3, 2), 8), ((4, 4), (1, 2), 16)))


def _random_model(dtype="float32", pad=0):
    torch.manual_seed(0)
    model = NHANSNet(ModelConfig(**_SMALL, compute_dtype=dtype,
                                 freq_pad_to=pad))
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3)
        for name, b in model.named_buffers():
            if "variance" in name:
                b.uniform_(0.5, 2.0)
            else:
                b.normal_(0.0, 0.3)
    return model.eval()


@pytest.mark.parametrize("dtype,pad", [("float32", 0), ("float32", 256),
                                       ("bfloat16", 0)])
@pytest.mark.parametrize("training,mode,fused", [
    (False, torch.no_grad, True), (False, torch.inference_mode, True),
    (False, torch.enable_grad, False), (True, torch.no_grad, False)])
def test_fused_block_routes_its_convolutions_and_equals_the_modules(
        monkeypatch, dtype, pad, training, mode, fused):
    """conv1 and conv2 of every block go through ops.tower_conv in float32
    inference with grad off, nowhere else; on the CPU that path equals the
    modules bit for bit, the lane-padded geometry included."""
    calls = []
    real = nn_model.tower_conv

    def counting(x, w, b, stride, pads):
        calls.append((tuple(x.shape), tuple(w.shape), tuple(pads)))
        return real(x, w, b, stride, pads)

    model = _random_model(dtype, pad)
    model.train(training)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 35, 201, generator=g) * 2.0
    ea, eb = torch.randn(3, 16, generator=g), torch.randn(3, 16, generator=g)
    with torch.enable_grad():
        ref = model(x, emb_a=ea, emb_b=eb)
    monkeypatch.setattr(nn_model, "tower_conv", counting)
    with mode():
        got = model(x, emb_a=ea, emb_b=eb)
    routed = fused and dtype == "float32"
    assert len(calls) == (2 * len(_SMALL["main_blocks"]) if routed else 0)
    if routed and pad:
        assert calls[0][0][3] == pad              # the padded width runs
    if not training:
        assert torch.equal(got, ref)


# -- the CUDA kernel, emulated -----------------------------------------------

def _tile(kh, kw, cin, cout):
    """(BN, light) as nhans_tower_conv chooses them."""
    if (kh, kw) in ((4, 4), (8, 4)):
        return (64, True) if cin == 1 and cout <= 64 else (
            (64, False) if cout <= 64 else (128, False))
    return 256, False


def _emulate(x, w, b, stride, pads):
    """The kernel's indexing in numpy, in float64: each block's tile, each
    thread's copies of the input taps and weight chunks into the step's
    tiles (every cell written once), the product, and the staged store;
    the sum's order aside, what the kernel computes."""
    N, Cin, H, W = x.shape
    Cout, _, KH, KW = w.shape
    sh, sw = stride
    pl, pr, pt, pb = pads
    Ho, Wo = tc.out_size(H, KH, sh, pt, pb), tc.out_size(W, KW, sw, pl, pr)
    BN, light = _tile(KH, KW, Cin, Cout)
    threads, taps_n = 256, KH * KW
    BM = threads * 64 // BN
    groups = threads // BM
    channels = (groups if light or taps_n >= 32 else
                2 if taps_n >= 16 else 4)
    own, BK = channels // groups, channels * taps_n
    K, P, M, HW = Cin * taps_n, Ho * Wo, N * Ho * Wo, H * W
    xf = x.double().numpy().ravel()
    ldw = -(-Cout // 4) * 4                 # wt's columns, zeros past Cout
    wt = np.zeros((K, ldw))
    wt[:, :Cout] = w.double().reshape(Cout, -1).t().numpy()
    bias = np.zeros(Cout) if b is None else b.double().numpy()
    y = np.full(N * Cout * P, np.nan)
    n_tiles = -(-Cout // BN)
    steps = -(-Cin // channels)
    tid = np.arange(threads)
    am, ag = tid % BM, tid // BM
    rs = [(r, s) for r in range(KH) for s in range(KW)]
    for blk in range(-(-M // BM) * n_tiles):
        n0, m0 = (blk % n_tiles) * BN, (blk // n_tiles) * BM
        m = m0 + am
        img, q = m // P, m % P
        hi, wi = (q // Wo) * sh - pt, (q % Wo) * sw - pl
        taps = np.stack([(m < M) & (hi + r >= 0) & (hi + r < H)
                         & (wi + s >= 0) & (wi + s < W) for r, s in rs], 1)
        at = (img * Cin + ag) * HW + hi * W + wi
        A = np.zeros((steps * BK, BM))
        B = np.zeros((steps * BK, BN))
        seen_a = np.zeros((steps * BK, BM), int)
        seen_b = np.zeros((steps * BK, BN), int)
        for step in range(steps):
            for o in range(own):
                c = step * channels + ag + groups * o
                base = at + (step * channels + groups * o) * HW
                row0 = step * BK + (ag + groups * o) * taps_n
                for t, (r, s) in enumerate(rs):
                    ok = taps[:, t] & (c < Cin)
                    src = np.where(ok, base + r * W + s, 0)
                    A[row0 + t, am] = np.where(ok, xf[src], 0.0)
                    seen_a[row0 + t, am] += 1
            chunks = BK * BN // 4
            for u in range(-(-chunks // threads)):
                ch = u * threads + tid
                ch = ch[ch < chunks]
                row, col = ch // (BN // 4), (ch % (BN // 4)) * 4
                k = step * BK + row
                ok = (k < K) & (n0 + col < ldw)     # 16 bytes a copy
                for e in range(4):
                    B[k, col + e] = np.where(
                        ok, wt[np.minimum(k, K - 1),
                               np.minimum(n0 + col + e, ldw - 1)], 0.0)
                    seen_b[k, col + e] += 1
        assert (seen_a == 1).all() and (seen_b == 1).all()
        acc = A.T @ B                                    # [BM, BN]
        for c in range(min(BN, Cout - n0)):
            mm = m0 + np.arange(BM)
            keep = mm < M
            out = (mm // P) * Cout * P + mm % P
            y[out[keep] + (n0 + c) * P] = acc[keep, c] + bias[n0 + c]
    return torch.from_numpy(y.reshape(N, Cout, Ho, Wo))


@pytest.mark.parametrize("cin,cout,k,s,H,W,width", [
    (1, 64, (8, 4), (3, 2), 14, 13, 13),  # 8 x 4: the light tile
    (3, 64, (8, 4), 1, 9, 13, 13),        # 8 x 4, 256 x 64, 1 channel a step
    (3, 72, (8, 4), (3, 2), 14, 11, 11),  # 8 x 4, 128 x 128, 3 stages
    (1, 64, 4, 1, 7, 13, 13),       # the light tile
    (1, 8, 4, 1, 5, 9, 16),         # light, lane-padded, Cout < BN
    (3, 64, 4, 1, 9, 13, 13),       # 256 x 64
    (2, 6, 4, 1, 9, 13, 13),        # 6 channels: weights padded to 8
    (5, 132, 4, 2, 9, 13, 13),      # 128 x 128, a second column tile
    (3, 128, 4, 1, 6, 10, 16),      # lane-padded
    (6, 20, 3, 2, 9, 13, 13),       # 64 x 256, 20 of its columns stored
    (3, 3, 3, 1, 5, 7, 7),          # 3 channels, weights padded to 4
    (5, 260, 3, 1, 5, 7, 7),        # two column tiles, 4 in the second
    (9, 256, 3, 2, 9, 51, 64),      # a stage-3 input, lane-padded
])
def test_kernel_emulation_is_the_convolution(cin, cout, k, s, H, W, width):
    kh, kw = k if isinstance(k, tuple) else (k, k)
    sh, sw = s if isinstance(s, tuple) else (s, s)
    g = torch.Generator().manual_seed(cin * cout + kh)
    x = torch.randn(3, cin, H, width, generator=g)
    w = torch.randn(cout, cin, kh, kw, generator=g)
    b = torch.randn(cout, generator=g)
    st = (sh, sw)
    fl, fh, _ = same_pads(W, kw, sw)
    tl, th, _ = same_pads(H, kh, sh)
    pads = (fl, fh, tl, th)
    got = _emulate(x, w, b, st, pads)
    ref = F.conv2d(F.pad(x.double(), pads), w.double(), b.double(),
                   stride=st)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("BN", [64, 128, 256])
def test_kernel_thread_tiles_cover_the_block_once(BN):
    """Each thread's 8 x 8 accumulators (positions tm + {0..3, 16..19},
    channels tn + {0..3, 32..35}) cover the BM x BN tile once."""
    BM = 256 * 64 // BN
    seen = np.zeros((BM, BN), int)
    for tid in range(256):
        warp, lane = tid // 32, tid % 32
        tm = (warp % (BM // 32)) * 32 + (lane & 3) * 4
        tn = (warp // (BM // 32)) * 64 + (lane >> 2) * 4
        for i in range(8):
            for j in range(8):
                seen[tm + i % 4 + i // 4 * 16, tn + j % 4 + j // 4 * 32] += 1
    assert (seen == 1).all()


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _smoke():
    import chip_smoke

    return chip_smoke


TOWER = [(i, n) for i in range(16) for n in (2048, 795, 37, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("conv,windows", TOWER)
def test_kernel_within_the_float32_bound_on_card(conv, windows):
    """Every output within (K + 1) u (sum |x| |w| + |b|) of the float64
    convolution, and the rms error at most twice cuDNN's float32 one."""
    _cuda()
    cs = _smoke()
    name, cin, cout, k, s, H, W = cs.tower_convs(
        Config.denoiser().model)[conv]
    x, w, b, st, pads = cs.conv_inputs(windows, cin, cout, k, s, H, W,
                                       "cuda", windows + conv)
    got = tc.tower_conv(x, w, b, st, pads)
    over, rms, rms_lib = cs.conv_gaps(x, w, b, st, pads, got)
    assert over <= 1.0, name
    assert rms <= 2 * rms_lib, name


@pytest.mark.gpu
@pytest.mark.parametrize("conv", [0, 1, 4, 8, 9, 12, 15])
def test_kernel_non_finite_values_as_f_conv2d_on_card(conv):
    """NaN and infinities in the input: NaN, +inf and -inf at the places
    F.conv2d's direct sum (the CPU, float64) puts them; finite outputs
    within 1e-4 relative."""
    _cuda()
    cs = _smoke()
    _, cin, cout, k, s, H, W = cs.tower_convs(Config.denoiser().model)[conv]
    x, w, b, st, pads = cs.conv_inputs(3, cin, cout, k, s, H, W, "cuda",
                                       conv)
    x[0, 0, 0, 1] = float("nan")
    x[1, -1, H // 2, W // 2] = float("inf")
    x[2, 0, H - 1, W - 1] = float("-inf")
    x[2, -1, 0, 0] = float("inf")
    got = tc.tower_conv(x, w, b, st, pads).cpu()
    ref = F.conv2d(F.pad(x.cpu().double(), pads), w.cpu().double(),
                   None if b is None else b.cpu().double(), stride=st)
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(ref))
    assert torch.isnan(got).any() and torch.isinf(got).any()
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin].double(), ref[fin], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [2048, 1])
def test_tower_forward_launches_16_convolutions_on_card(windows):
    """One forward of the shipped tower: one kernel launch per k x k
    convolution, in inference and, through the training convolutions
    (nn/model.py::_train_conv), with grad on."""
    _cuda()
    model = NHANSNet(Config.denoiser().model).cuda().eval()
    model.requires_grad_(False)
    x = torch.randn(windows, 35, 201, device="cuda")
    e = torch.randn(windows, 512, device="cuda")
    blocks = len(Config.denoiser().model.main_blocks)
    for mode, launches in ((torch.inference_mode, 2 * blocks),
                           (torch.no_grad, 2 * blocks),
                           (torch.enable_grad, 2 * blocks)):
        before = tc.tower_conv.launches
        with mode():
            model(x, emb_a=e, emb_b=e)
        assert tc.tower_conv.launches - before == launches
    del model, x, e
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_lane_padded_tower_equals_the_native_one_on_card():
    """The shipped denoiser in the lane-padded geometry (256 columns, the
    convolutions' pads set for the true width) against the native one:
    the kernel reads the dead columns' zeros where the native tower reads
    SAME padding, so the residuals agree within TOWER_RTOL."""
    import dataclasses

    from nhans_tpu_torch.compat.weights import load_npz

    _cuda()
    cs = _smoke()
    cfg = Config.denoiser().model
    weights = load_npz(cs.os.path.join(cs.REPO, "docs", "quality",
                                       "denoiser_q5_swa.npz"))
    out = {}
    for pad in (0, 256):
        model = NHANSNet(dataclasses.replace(cfg, freq_pad_to=pad))
        model.load_state_dict(weights, strict=True)
        model = model.cuda().eval().requires_grad_(False)
        g = torch.Generator(device="cuda").manual_seed(37)
        x = torch.randn(37, 35, 201, device="cuda", generator=g) * 2 - 4
        e = torch.randn(37, 512, device="cuda", generator=g)
        before = tc.tower_conv.launches
        with torch.inference_mode():
            out[pad] = model(x, emb_a=e, emb_b=e)
        assert tc.tower_conv.launches - before == 2 * len(cfg.main_blocks)
    diff = (out[256] - out[0]).abs().max().item()
    assert diff <= cs.TOWER_RTOL * out[0].abs().max().item()
