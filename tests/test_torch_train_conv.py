"""The training step's convolutions on the hand-written kernels
(nhans_tpu_torch.ops.tower_conv.TrainConv, ops.conv_wgrad and the routing
of nn/model.py::_train_conv).

On the CPU, at narrow widths and the towers' own sizes, kernels, strides
and pads: the input gradient of a stride-1 convolution taken as a
forward convolution of the output gradient with the weights rotated and
the pads mirrored, and the strided ones' on the padded geometry, lie
within the float32 sum's bound of ``torch.nn.grad.conv2d_input`` in
float64; the plain weight and bias gradients within that bound of
``conv2d_weight`` and of dy's sum; ``TrainConv``'s backward is those
functions'; the slices of the weight gradient's sum cover it within the
workspace, and the layers of one input channel take the narrow kernel's
tile of their width; the weight-gradient kernels' indexing, emulated in
numpy (its division by multiplication too), is conv2d_weight's sum,
through odd Ho x Wo, steps across rows and images and the narrow tiles;
the wrapper refuses what the kernel does not take; and the
training step on the CPU, in float32 and bfloat16, is today's bit for bit
(the routing sends nothing to the kernels there), while with the CPU let
through the routing sends exactly the 24 k x k convolutions of both
towers, with the modules' gradients.  On the card (marker ``gpu``): each
of the 24 convolutions at full width and 64 windows, forward, input and
weight gradient, within the float32 bound of the float64 result and with
an rms error at most ``TRAIN_CONV_RMS_X`` times cuDNN's float32 one (TF32
off), the weight gradient bit for bit across two runs; and a full step's
gradients against the modules', leaf by leaf.  The machine with the card
has no JAX: this module imports none, and the card runs it with
``python -m pytest --noconftest -m gpu tests/test_torch_train_conv.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.nn import model as nn_model
from nhans_tpu_torch.nn.blocks import same_pads
from nhans_tpu_torch.nn.model import NHANSNet, freq_weighted_mse, hand_convs
from nhans_tpu_torch.ops import conv_wgrad as cw
from nhans_tpu_torch.ops import tower_conv as tc

U = 2.0 ** -24


# both towers' 24 k x k convolutions as a training step runs them, at 2
# windows: (name, N, cin, cout, kernel, stride, H, W, bias, calls)
CONVS = chip_smoke.train_convs(Config.separator().model, 2)
NAMES = [c[0] for c in CONVS]


def _narrow(conv, seed, dtype=torch.float32):
    """The convolution at its own size, kernel, stride and pads with at
    most 3 input and 4 output channels: x, w, b, stride, pads, dy."""
    _, N, cin, cout, (kh, kw), (sh, sw), H, W, bias, _ = conv
    cin, cout = min(cin, 3), min(cout, 4)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, cin, H, W, generator=g, dtype=dtype)
    w = torch.randn(cout, cin, kh, kw, generator=g, dtype=dtype)
    b = torch.randn(cout, generator=g, dtype=dtype) if bias else None
    tl, th, _ = same_pads(H, kh, sh)
    fl, fh, _ = same_pads(W, kw, sw)
    pads = (fl, fh, tl, th)
    Ho = tc.out_size(H, kh, sh, tl, th)
    Wo = tc.out_size(W, kw, sw, fl, fh)
    dy = torch.randn(N, cout, Ho, Wo, generator=g, dtype=dtype)
    return x, w, b, (sh, sw), pads, dy


def _within(got, exact, mag, K):
    """Every value within the float32 sum's worst case (K + 1) u mag of
    the float64 result."""
    assert got.shape == exact.shape
    err = (got.double() - exact).abs()
    assert (err <= (K + 1) * U * mag + 1e-300).all(), err.max().item()


def _input_grad64(conv, w, dy, pads, x_shape, absolute=False):
    _, _, _, _, (kh, kw), stride, _, _, _, _ = conv
    pl, pr, pt, pb = pads
    N, cin, H, W = x_shape
    w, dy = w.double(), dy.double()
    if absolute:
        w, dy = w.abs(), dy.abs()
    dx = torch.nn.grad.conv2d_input((N, cin, H + pt + pb, W + pl + pr), w,
                                    dy, stride)
    return dx[:, :, pt:pt + H, pl:pl + W]


@pytest.mark.parametrize("i", range(len(CONVS)), ids=NAMES)
def test_input_grad_is_conv2d_input(i):
    """Stride 1: a forward of dy with w rotated by 180 degrees and the pads
    (k - 1 - lo, k - 1 - hi), through tower_conv (on the CPU its plain
    version); strided: cuDNN's (here ATen's) input gradient on the padded
    geometry, cropped.  Both within the float32 bound of conv2d_input."""
    conv = CONVS[i]
    x, w, b, stride, pads, dy = _narrow(conv, 10 + i)
    got = tc.input_grad(dy, w, x.shape, stride, pads)
    exact = _input_grad64(conv, w, dy, pads, x.shape)
    mag = _input_grad64(conv, w, dy, pads, x.shape, absolute=True)
    _within(got, exact, mag, w.shape[0] * w.shape[2] * w.shape[3])


@pytest.mark.parametrize("pad_to", [0, 256])
def test_input_grad_in_the_lane_padded_geometry(pad_to):
    """The main tower's first block in the lane-padded geometry: 256
    columns, the pads set for the true 201."""
    g = torch.Generator().manual_seed(pad_to)
    width = pad_to or 201
    x_shape = (2, 3, 35, width)
    w = torch.randn(4, 3, 4, 4, generator=g)
    tl, th, _ = same_pads(35, 4, 1)
    fl, fh, _ = same_pads(201, 4, 1)
    pads = (fl, fh, tl, th)
    dy = torch.randn(2, 4, tc.out_size(35, 4, 1, tl, th),
                     tc.out_size(width, 4, 1, fl, fh), generator=g)
    conv = ("", 2, 3, 4, (4, 4), (1, 1), 35, width, False, 1)
    got = tc.input_grad(dy, w, x_shape, (1, 1), pads)
    _within(got, _input_grad64(conv, w, dy, pads, x_shape),
            _input_grad64(conv, w, dy, pads, x_shape, absolute=True), 64)


@pytest.mark.parametrize("i", range(len(CONVS)), ids=NAMES)
def test_plain_weight_and_bias_gradients_are_conv2d_weight(i):
    """conv_wgrad on CPU tensors (the plain version, F.unfold's columns
    against dy) within the float32 bound of conv2d_weight in float64, and
    db of dy's sum, at every kernel, stride and pad pattern."""
    conv = CONVS[i]
    x, w, b, stride, pads, dy = _narrow(conv, 40 + i)
    before = cw.conv_wgrad.launches
    dw, db = cw.conv_wgrad(x, dy, conv[4], stride, pads, b is not None)
    assert cw.conv_wgrad.launches == before
    xp = F.pad(x.double(), pads)
    exact = torch.nn.grad.conv2d_weight(xp, w.shape, dy.double(), stride)
    mag = torch.nn.grad.conv2d_weight(xp.abs(), w.shape, dy.double().abs(),
                                      stride)
    K = dy.shape[0] * dy.shape[2] * dy.shape[3]
    _within(dw, exact, mag, K)
    if b is None:
        assert db is None
    else:
        _within(db, dy.double().sum((0, 2, 3)),
                dy.double().abs().sum((0, 2, 3)), K)


@pytest.mark.parametrize("i", range(len(CONVS)), ids=NAMES)
def test_weight_gradient_slices_cover_the_sum(i):
    """At full width and 64 windows: the slices cover the sum over the
    positions once, in whole steps of the kernel's (32 positions, 128 for
    the one-channel layers) and at least 8 steps each, their
    partial sums under 64 MB, and the blocks fill at least 90 % of their
    waves of 132 SMs where the sum is long enough to cut."""
    _, _, cin, cout, (kh, kw), stride, H, W, _, _ = CONVS[i]
    Ho = same_pads(H, kh, stride[0])[2]
    Wo = same_pads(W, kw, stride[1])[2]
    K, cols = 64 * Ho * Wo, cin * kh * kw
    S, per = cw.wgrad_slices(cout, cin, (kh, kw), K)
    bm, bn, step = cw.tile(cout, cin, (kh, kw))
    assert per % step == 0 and S * per >= K > (S - 1) * per
    assert S == 1 or per >= step * cw.MIN_STEPS
    assert S == 1 or 4 * S * (cout * cols + cout) < 64 * 2 ** 20
    blocks = -(-cout // bm) * -(-cols // bn) * S
    if K >= 132 * step * cw.MIN_STEPS:
        assert blocks / (-(-blocks // 132) * 132) >= 0.9


def test_one_channel_layers_take_a_tile_of_their_width():
    """The towers' first convolutions (one input channel: 16 or 32 columns)
    take the narrow kernel's 64 x 16 or 64 x 32 tile and 128 positions a
    step, every other of the 24 more than 32 columns and the wide tiles."""
    for _, _, cin, cout, kernel, _, _, _, _, _ in CONVS:
        cols = cin * kernel[0] * kernel[1]
        bm, bn, step = cw.tile(cout, cin, kernel)
        if cin == 1:
            assert (bm, bn, step) == (64, cols, cw.NARROW_STEP)
        else:
            assert cols > cw.NARROW_COLS and step == cw.STEP
            assert (bm, bn) == ((64, 256) if kernel[1] == 4 and cout <= 64
                                else (128, 128))
    assert sum(c[2] == 1 for c in CONVS) == 2


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w, b, stride, pads, dy = _narrow(CONVS[3], 0)
    k = (4, 4)
    bad = [
        (x.double(), dy, k, stride, pads),
        (x, dy.to(torch.bfloat16), k, stride, pads),
        (x.transpose(2, 3), dy, k, stride, pads),
        (x, dy[:, :, :, ::2], k, stride, pads),
        (x, dy, (5, 5), stride, pads),
        (x, dy, (4, 3), stride, pads),
        (x, dy, k, (0, 1), pads),
        (x, dy, k, stride, (-1, 2, 1, 2)),
        (x, dy[:1], k, stride, pads),
        (x, dy[:, :, 1:], k, stride, pads),
        (x[0], dy, k, stride, pads),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cw.conv_wgrad(*args, True)


@pytest.mark.parametrize("i", [2, 5, 16, 17, 18, 23], ids=[
    NAMES[j] for j in (2, 5, 16, 17, 18, 23)])
@pytest.mark.parametrize("grads", ["all", "weights", "input"])
def test_train_conv_backward_is_its_functions(i, grads):
    """TrainConv's forward is tower_conv and its backward input_grad and
    conv_wgrad, bit for bit, for the arguments that need a gradient; the
    others get None."""
    conv = CONVS[i]
    x, w, b, stride, pads, dy = _narrow(conv, 70 + i)
    x.requires_grad_(grads in ("all", "input"))
    w.requires_grad_(grads in ("all", "weights"))
    if b is not None:
        b.requires_grad_(grads in ("all", "weights"))
    y = tc.TrainConv.apply(x, w, b, stride, pads)
    assert torch.equal(y, tc.tower_conv(x.detach(), w.detach(),
                                        None if b is None else b.detach(),
                                        stride, pads))
    y.backward(dy)
    want_dw, want_db = cw.conv_wgrad(x.detach(), dy, conv[4], stride, pads,
                                     b is not None)
    if x.requires_grad:
        assert torch.equal(x.grad, tc.input_grad(dy, w.detach(), x.shape,
                                                 stride, pads))
    else:
        assert x.grad is None
    if w.requires_grad:
        assert torch.equal(w.grad, want_dw)
        if b is not None:
            assert torch.equal(b.grad, want_db)
    else:
        assert w.grad is None and (b is None or b.grad is None)


# -- the weight-gradient kernel, emulated ------------------------------------

def _div_magic(d):
    """conv_wgrad.cu's Div: (m, shift) with floor(n / d) = n m >> shift."""
    bits = 0
    while (1 << bits) < d:
        bits += 1
    return ((1 << (31 + bits)) + d - 1) // d, 31 + bits


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 9, 10, 13, 17, 18, 26, 35,
                               51, 67, 101, 201, 2 ** 20 + 1, 2 ** 30 - 1])
def test_division_by_multiplication_is_exact(d):
    """The kernel's divisions of a position by Wo and of an output row by
    Ho: exact for every dividend below 2^31 (checked at the multiples of d
    and their neighbours, the ends and random draws), and the product
    within 64 bits."""
    m, shift = _div_magic(d)
    rng = np.random.default_rng(d)
    top = 2 ** 31 - 1
    qs = np.unique(np.concatenate([np.arange(0, 2000),
                                   rng.integers(0, top // d + 1, 4000),
                                   [top // d - 1, top // d]]))
    ns = {0, top} | {int(v) for v in rng.integers(0, top, 4000)}
    for qv in qs.tolist():
        for n in (qv * d - 1, qv * d, qv * d + d - 1):
            if 0 <= n <= top:
                ns.add(n)
    for n in ns:
        assert (n * m) >> shift == n // d, n
        assert n * m < 2 ** 64
    assert m < 2 ** 33


def _positions(k, Wo, Ho):
    R = k // Wo
    n = R // Ho
    return R, n, R - n * Ho, k - R * Wo


def _emulate_wide_step(xf, dyf, shape, geo, A, B, seen_a, seen_b, k0, ke):
    """One step of conv_wgrad (more than 32 columns), as its threads copy
    it: each thread's position q, A rows e + 4 h + 8 u and B columns
    4 (h + 2 u) + e; for a kernel 4 wide each column from its channel,
    kernel row and s = e, zero past J, else from its own (ci, r, s), a
    column past J reading the last; a tap inside the image or a zero."""
    N, Cin, H, W, Cout, Ho, Wo, KH, KW, sh, sw, pt, pl = shape
    BM, BN, co0, j0 = geo
    P, HW, T = Ho * Wo, H * W, KH * KW
    J = Cin * T
    tid = np.arange(256)
    warp, lane = tid // 32, tid % 32
    q, e, h = (lane & 7) + 8 * (warp & 3), lane >> 3, warp >> 2
    k = k0 + q
    k_ok = k < ke
    R, n, ho, wo = _positions(k, Wo, Ho)
    hi, wi = ho * sh - pt, wo * sw - pl
    at = (n * Cout + co0 + e + 4 * h) * P + (k - n * P)
    for u in range(BM // 8):
        row = e + 4 * h + 8 * u
        ok = k_ok & (co0 + row < Cout)
        A[q, row] = np.where(ok, dyf[np.where(ok, at + 8 * u * P, 0)], 0.0)
        seen_a[q, row] += 1
    x0 = n * Cin * HW + hi * W + wi
    for u in range(BN // 8):
        j = j0 + 4 * (h + 2 * u) + e
        if KW == 4:
            assert j0 % T == 0
            G = h + 2 * u
            ci, r, s = j0 // T + G // KH, G % KH, e
            live = j < J
        else:
            jj = np.minimum(J - 1, j)
            ci, tap = jj // T, jj % T
            r, s = tap // KW, tap % KW
            live = True
        ok = (k_ok & live & (hi + r >= 0) & (hi + r < H) & (wi + s >= 0)
              & (wi + s < W))
        src = x0 + ci * HW + r * W + s
        B[q, j - j0] = np.where(ok, xf[np.where(ok, src, 0)], 0.0)
        seen_b[q, j - j0] += 1


def _emulate_narrow_step(xf, dyf, shape, co0, A, B, seen_a, seen_b, k0, ke):
    """One step of conv_wgrad_narrow (at most 32 columns), as its threads
    copy it: positions kk and kk + 64 of each thread, rows and columns
    rr + 4 u, a tap inside the image or a zero."""
    N, Cin, H, W, Cout, Ho, Wo, KH, KW, sh, sw, pt, pl = shape
    P, HW, T = Ho * Wo, H * W, KH * KW
    BN = B.shape[1]
    tid = np.arange(256)
    warp, lane = tid // 32, tid % 32
    kk, rr = (lane & 7) + 8 * warp, lane >> 3
    for h in range(2):
        q = kk + 64 * h
        k = k0 + q
        k_ok = k < ke
        R, n, ho, wo = _positions(k, Wo, Ho)
        hi, wi = ho * sh - pt, wo * sw - pl
        a_at = (n * Cout + co0 + rr) * P + (k - n * P)
        for u in range(16):
            ok = k_ok & (co0 + rr + 4 * u < Cout)
            A[q, rr + 4 * u] = np.where(ok, dyf[np.where(ok, a_at + 4 * u * P,
                                                         0)], 0.0)
            seen_a[q, rr + 4 * u] += 1
        for u in range(BN // 4):
            j = rr + 4 * u
            ci, tap = j // T, j % T
            r, s = tap // KW, tap % KW
            ok = (k_ok & (j < Cin * T) & (hi + r >= 0) & (hi + r < H)
                  & (wi + s >= 0) & (wi + s < W))
            src = n * Cin * HW + hi * W + wi + ci * HW + r * W + s
            B[q, j] = np.where(ok, xf[np.where(ok, src, 0)], 0.0)
            seen_b[q, j] += 1


def _emulate_wgrad(x, dy, kernel, stride, pads, bias):
    """conv_wgrad.cu's indexing in numpy, in float64: the tile and slices
    ``tile`` and ``wgrad_slices`` choose; for each block, slice and step
    the kernel's copies and B tile (each cell of the A and B tiles written
    once), for the narrow kernel each position taken by one group of
    threads; the tile's product, the store of the rows and columns inside
    the gradient, the bias rows' sums, and the slices added in order: the
    sums' order aside, what the kernel computes."""
    N, Cin, H, W = x.shape
    Cout, Ho, Wo = dy.shape[1:]
    KH, KW = kernel
    sh, sw = stride
    pl, pr, pt, pb = pads
    T = KH * KW
    J, K = Cin * T, N * Ho * Wo
    S, per = cw.wgrad_slices(Cout, Cin, (KH, KW), K)
    BM, BN, BK = cw.tile(Cout, Cin, (KH, KW))
    narrow = J <= cw.NARROW_COLS
    shape = (N, Cin, H, W, Cout, Ho, Wo, KH, KW, sh, sw, pt, pl)
    if narrow:
        groups = 256 // ((BM // 8) * (BN // 8))
        taken = np.zeros(BK, int)
        for grp in range(groups):
            taken[grp + groups * np.arange(BK // groups)] += 1
        assert (taken == 1).all()
    xf, dyf = x.double().numpy().ravel(), dy.double().numpy().ravel()
    ws, wsb = np.full((S, Cout, J), np.nan), np.full((S, Cout), np.nan)
    j_tiles = -(-J // BN)
    for blk in range(-(-Cout // BM) * j_tiles):
        j0, co0 = (blk % j_tiles) * BN, (blk // j_tiles) * BM
        for sl in range(S):
            kb = sl * per
            ke = min(K, kb + per)
            steps = -(-(ke - kb) // BK)
            A, B = np.zeros((steps * BK, BM)), np.zeros((steps * BK, BN))
            seen_a, seen_b = np.zeros(A.shape, int), np.zeros(B.shape, int)
            for step in range(steps):
                rows = slice(step * BK, (step + 1) * BK)
                if narrow:
                    _emulate_narrow_step(xf, dyf, shape, co0, A[rows], B[rows],
                                         seen_a[rows], seen_b[rows],
                                         kb + step * BK, ke)
                else:
                    _emulate_wide_step(xf, dyf, shape, (BM, BN, co0, j0),
                                       A[rows], B[rows], seen_a[rows],
                                       seen_b[rows], kb + step * BK, ke)
            assert (seen_a == 1).all() and (seen_b == 1).all()
            tile_ = A.T @ B
            rows = min(BM, Cout - co0)
            cols = min(BN, J - j0)
            ws[sl, co0:co0 + rows, j0:j0 + cols] = tile_[:rows, :cols]
            if bias and j0 == 0:
                wsb[sl, co0:co0 + rows] = A[:, :rows].sum(0)
    dw = ws[0]
    for sl in range(1, S):
        dw = dw + ws[sl]
    db = wsb.sum(0) if bias else None
    return torch.from_numpy(dw.reshape(Cout, Cin, KH, KW)), (
        None if db is None else torch.from_numpy(db))


@pytest.mark.parametrize("cin,cout,kernel,stride,H,W,N", [
    (3, 5, (8, 4), (3, 2), 20, 21, 9),      # 64 x 256, steps over 4 rows
    (3, 70, (8, 4), (1, 1), 9, 11, 4),      # 128 x 128, 2 row tiles
    (1, 6, (4, 4), (1, 1), 13, 29, 2),      # one input channel: 64 x 16
    (2, 64, (4, 4), (2, 2), 17, 23, 5),     # 32 columns: 64 x 32
    (3, 64, (4, 4), (2, 2), 17, 23, 5),     # stride 2, odd W, 64 x 256
    (30, 8, (3, 3), (1, 1), 5, 26, 6),      # 3 x 3: 128 x 128, 3 column tiles
    (4, 130, (3, 3), (2, 2), 9, 51, 2),     # 2 row tiles, 2 left over
    (3, 9, (4, 4), (1, 2), 23, 51, 2),      # stride (1, 2), Wo 26
    (3, 5, (4, 4), (1, 1), 35, 201, 2),     # odd Ho x Wo, steps across images
    (1, 64, (4, 4), (1, 1), 35, 201, 2),    # the main tower's one channel
    (1, 64, (8, 4), (3, 2), 200, 201, 1),   # the context tower's one channel
    (2, 3, (3, 3), (1, 1), 7, 9, 3),        # 18 columns, 3 x 3: 64 x 32
])
def test_weight_gradient_kernel_emulation_is_conv2d_weight(
        cin, cout, kernel, stride, H, W, N):
    g = torch.Generator().manual_seed(cin * cout)
    kh, kw = kernel
    tl, th, _ = same_pads(H, kh, stride[0])
    fl, fh, _ = same_pads(W, kw, stride[1])
    pads = (fl, fh, tl, th)
    x = torch.randn(N, cin, H, W, generator=g)
    dy = torch.randn(N, cout, tc.out_size(H, kh, stride[0], tl, th),
                     tc.out_size(W, kw, stride[1], fl, fh), generator=g)
    dw, db = _emulate_wgrad(x, dy, kernel, stride, pads, True)
    want = torch.nn.grad.conv2d_weight(F.pad(x.double(), pads),
                                       (cout, cin, kh, kw), dy.double(),
                                       stride)
    torch.testing.assert_close(dw, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, dy.double().sum((0, 2, 3)), rtol=1e-12,
                               atol=1e-12)


# -- the routing -------------------------------------------------------------

def _layout_model(dtype="float32", seed=0):
    """The separator's blocks, kernels and strides at narrow widths and 40
    context frames."""
    sep = Config.separator().model
    main = tuple((k, s, c // 32) for k, s, c in sep.main_blocks)
    ctx = tuple((k, s, c // 32) for k, s, c in sep.context_blocks)
    cfg = dataclasses.replace(sep, main_blocks=main, context_blocks=ctx,
                              context_frames=40, embedding_dim=6,
                              pos_embed_hidden=5, compute_dtype=dtype)
    torch.manual_seed(seed)
    model = NHANSNet(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3)
    return model.train(), cfg


def _step(model, cfg, seed=1):
    """One training forward and backward on 3 random windows: the loss, the
    gradients, the batch statistics and the count of convolutions that
    took the kernels."""
    g = torch.Generator().manual_seed(seed)
    W, C, F_ = cfg.window_frames, cfg.context_frames, cfg.num_features
    mixed = torch.randn(3, W, F_, generator=g) - 4
    ctx = [torch.randn(3, C, F_, generator=g) - 4 for _ in range(2)]
    target = mixed[:, W // 2] + 0.1 * torch.randn(3, F_, generator=g)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.zero_grad(set_to_none=True)
    with hand_convs() as seen:
        res = model(mixed, *ctx)
        loss, _ = freq_weighted_mse(mixed[:, W // 2] + res, target)
    loss.backward()
    out = ({k: p.grad.clone() for k, p in model.named_parameters()},
           {k: v.clone() for k, v in model.state_dict().items()
            if "pop_" in k}, loss.detach(), len(seen))
    model.load_state_dict(state)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_step_is_todays_bit_for_bit(monkeypatch, dtype):
    """On the CPU the routing sends nothing to the kernels: loss,
    gradients and statistics equal the modules' bit for bit."""
    model, cfg = _layout_model(dtype)
    grads, stats, loss, count = _step(model, cfg)
    monkeypatch.setattr(nn_model, "_train_conv",
                        lambda conv, x, fs=None: conv(x, fs))
    want_grads, want_stats, want_loss, _ = _step(model, cfg)
    assert count == 0
    assert torch.equal(loss, want_loss)
    for k in want_grads:
        assert torch.equal(grads[k], want_grads[k]), k
    for k in want_stats:
        assert torch.equal(stats[k], want_stats[k]), k


def test_routing_sends_the_24_convolutions_with_the_modules_gradients(
        monkeypatch):
    """With the CPU let through, the 24 k x k convolutions of both towers
    (8 of the context tower, run on both contexts, and 16 of the main
    tower) take TrainConv, and nothing else does: the 1 x 1 shortcuts and
    the head keep the modules.  The gradients equal the modules' within
    float32 round-off; in bfloat16 none is routed."""
    model, cfg = _layout_model()
    want, want_stats, want_loss, _ = _step(model, cfg)
    routed = []
    real = tc.TrainConv.apply

    def counting(x, w, *args):
        routed.append(tuple(w.shape))
        return real(x, w, *args)

    monkeypatch.setattr(nn_model, "KERNEL_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(tc.TrainConv, "apply", counting)
    grads, stats, loss, count = _step(model, cfg)
    assert count == 24
    assert len(routed) == 16 + 2 * 8
    assert all(s[2:] != (1, 1) for s in routed)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    norms = {k: torch.linalg.vector_norm(v).item() for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    for k in want:
        gap = torch.linalg.vector_norm(grads[k] - want[k]).item()
        assert gap <= 1e-4 * max(norms[k], med), k
    for k in want_stats:
        torch.testing.assert_close(stats[k], want_stats[k], rtol=1e-5,
                                   atol=1e-6)
    bf16, bcfg = _layout_model("bfloat16")
    assert _step(bf16, bcfg)[3] == 0


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(CONVS)), ids=NAMES)
def test_directions_against_float64_and_cudnn_on_card(i):
    """Forward, input gradient (not for a layer that reads the data) and
    weight and bias gradients at full width and 64 windows: every value
    within the float32 sum's worst case of the float64 result, the rms
    error at most TRAIN_CONV_RMS_X times cuDNN's float32 one (both sum the
    same products in another order), and the weight gradient bit for bit
    across two runs (no atomics)."""
    _cuda()
    cs = chip_smoke
    conv = cs.train_convs(Config.separator().model)[i]
    args = cs.train_conv_inputs(conv, "cuda", 200 + i)
    for d, (mine, lib, exact, mag, K) in cs.train_conv_directions(
            conv, *args).items():
        got, ref, want, size = mine(), lib(), exact(), mag()
        if d == "weight":
            again = mine()
            assert torch.equal(got[0], again[0])
            parts = [(got[0], want[0], size[0], ref[0])]
            if got[1] is not None:
                assert torch.equal(got[1], again[1])
                parts.append((got[1], want[1], size[1], ref[1]))
        else:
            parts = [(got, want, size, ref)]
        for g, e, m, r in parts:
            over, rms, rms_lib = cs._gaps(g, e, m, K, r)
            assert over <= 1.0, (conv[0], d)
            assert rms <= cs.TRAIN_CONV_RMS_X * rms_lib, (conv[0], d, rms,
                                                         rms_lib)


@pytest.mark.gpu
def test_full_step_gradients_against_the_modules_on_card():
    """The separator at full width, 64 windows, from the shipped weights:
    24 convolutions and their epilogues take the kernels, and every
    leaf's gradient lies within STEP_GRAD_GAP of the modules' (cuDNN, TF32
    off), relative to the larger of the leaf's norm and the median
    leaf's."""
    import os

    from nhans_tpu_torch.compat.weights import load_npz

    _cuda()
    cs = chip_smoke
    weights = load_npz(os.path.join(cs.REPO, "docs", "quality",
                                    "separator_q5_swa.npz"))
    hand, modules, count, _ = cs.hand_step(
        "cuda", Config.separator().model, weights)
    assert count == (24, 24)
    gaps = cs.leaf_gaps(hand, modules)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= cs.STEP_GRAD_GAP, (worst, gaps[worst])
