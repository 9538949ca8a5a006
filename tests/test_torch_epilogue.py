"""The main tower's fused epilogue (nhans_tpu_torch.ops.tower_epilogue)
and the inference forward of CondResBlock that uses it.

On the CPU: the fused forward equals the modules' forward bit for bit, in
float32 and bfloat16, in the native and the lane-padded geometry, block by
block and through the whole model; training and grad take the modules;
the plain version equals a block's modules on NaN and infinities too; the
wrapper's dispatch and checks; and a numpy emulation of the CUDA kernel
(each lane's walk over its plane, the arithmetic in float32 and bfloat16
rounding) against the plain version, bit for bit.  On the card (marker
``gpu``): the kernel against the plain version at every block's real
shape and on non-finite values, and the fused tower against the modules
on the shipped weights (within a bound: its convolutions are
ops.tower_conv's).  The machine with the card has no JAX: this module
imports none, and the card runs it with
``python -m pytest --noconftest -m gpu tests/test_torch_epilogue.py``.
"""

import os

import numpy as np
import pytest
import torch

from nhans_tpu_torch.config import Config, ModelConfig
from nhans_tpu_torch.nn import model as nn_model
from nhans_tpu_torch.nn.model import CondResBlock, NHANSNet
from nhans_tpu_torch.ops import tower_epilogue as te

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMALL = dict(context_frames=40, embedding_dim=12, pos_embed_hidden=10,
              main_blocks=((4, 1, 8), (3, 2, 16), (3, 1, 16)),
              context_blocks=(((8, 4), (3, 2), 8), ((4, 4), (1, 2), 16)))
# each block's activation at full width, native geometry: (C, H, W)
BLOCK_SHAPES = [(64, 35, 201), (128, 18, 101), (256, 9, 51), (512, 5, 26)]


def _random_model(dtype="float32", pad=0, seed=0):
    """The reduced model with every leaf random: non-zero conditioning,
    BatchNorm statistics away from (0, 1), so that every add matters."""
    torch.manual_seed(seed)
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


def _bits(x):
    x = x.detach()
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad", [0, 256])
def test_fused_forward_equals_the_modules_bit_for_bit(dtype, pad):
    model = _random_model(dtype, pad)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(5, 35, 201, generator=g) * 2.0
    ea, eb = torch.randn(5, 16, generator=g), torch.randn(5, 16, generator=g)
    outs = {}
    for mode, ctx in (("fused", torch.no_grad), ("modules", torch.enable_grad)):
        seen = []
        hooks = [b.register_forward_hook(lambda m, i, o: seen.append(o))
                 for b in model.modules() if isinstance(b, CondResBlock)]
        with ctx():
            outs[mode] = (model(x, emb_a=ea, emb_b=eb), seen)
        for h in hooks:
            h.remove()
    (fused, f_blocks), (ref, r_blocks) = outs["fused"], outs["modules"]
    assert ref.requires_grad and not fused.requires_grad
    assert len(f_blocks) == len(r_blocks) == 3
    for f, r in zip(f_blocks, r_blocks):
        assert f.dtype == r.dtype == nn_model.compute_dtype(model.cfg)
        assert torch.equal(_bits(f), _bits(r))
        assert (f > 0).float().mean() > 0.2   # the ReLU keeps a share
    assert torch.equal(_bits(fused), _bits(ref))
    if pad:
        assert (f_blocks[-1][..., model.freq_out:] == 0).all()


@pytest.mark.parametrize("training,mode,fused", [
    (False, torch.no_grad, True), (False, torch.inference_mode, True),
    (False, torch.enable_grad, False), (True, torch.no_grad, False),
    (True, torch.enable_grad, False)])
def test_the_fused_path_only_in_inference_with_grad_off(monkeypatch,
                                                        training, mode,
                                                        fused):
    calls = []
    real = nn_model.tower_epilogue

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(nn_model, "tower_epilogue", counting)
    model = _random_model()
    model.train(training)
    x = torch.randn(4, 35, 201)
    e = torch.randn(4, 16)
    with mode():
        model(x, emb_a=e, emb_b=e)
    assert len(calls) == (2 * 3 if fused else 0)


def _non_finite(y, valid):
    """y with a NaN, +inf and -inf in a live column and in a dead one."""
    y = y.clone()
    for w in (1, valid + 1):
        y[0, 0, 0, w], y[0, 1, 1, w], y[-1, -1, -1, w] = (
            float("nan"), float("inf"), float("-inf"))
    return y


def _same(got, ref):
    """Equal bit for bit where finite, NaN at the same places."""
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(ref))
    assert torch.equal(_bits(got)[~nan], _bits(ref)[~nan])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("second", [False, True])
def test_plain_epilogue_is_the_modules_at_non_finite_values(dtype, second):
    """The plain version against a padded block's own modules (Inject,
    [residual,] BatchNorm, ReLU, mask) on an activation holding NaN and
    infinities: the dead columns are the result times 0, NaN included."""
    model = _random_model(dtype, pad=256)
    block = model.resblock3
    inject, bn = ((block.inject2, block.bn_out) if second
                  else (block.inject1, block.bn1))
    g = torch.Generator().manual_seed(3)
    valid = block.freq_out              # 101 of the block's 128 columns
    y = torch.randn(3, 16, 18, 128, generator=g).to(block.bn1.dtype)
    y = _non_finite(y, valid)
    res = (torch.randn(3, 16, 18, 128, generator=g).to(y.dtype) if second
           else None)
    e = torch.randn(3, 16, generator=g)
    with torch.no_grad():
        v = inject(y, e, e)
        ref = block._mask(torch.relu(bn(v if res is None else v + res)))
        got = te.tower_epilogue_plain(y, *inject.tables(y, e, e),
                                      *bn.eval_affine(), res, valid)
    assert torch.isnan(ref[..., valid:]).any()
    _same(got, ref)


def _tables(N, C, H, W, dtype, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    y = r(N, C, H, W, scale=2.0).to(dtype)
    tabs = [r(N, C).to(dtype), r(N, C).to(dtype), r(C, H).to(dtype),
            r(C, W).to(dtype), r(C, scale=0.5),
            torch.rsqrt(r(C).abs() + 0.5) * r(C), r(C, scale=0.5)]
    return y, tabs, r(N, C, H, W).to(dtype)


def test_wrapper_sends_cpu_tensors_to_plain_and_checks_its_inputs():
    y, tabs, res = _tables(3, 4, 5, 7, torch.float32)
    before = te.tower_epilogue.launches
    got = te.tower_epilogue(y, *tabs, residual=res, valid=6)
    assert te.tower_epilogue.launches == before
    assert torch.equal(got, te.tower_epilogue_plain(y, *tabs, res, 6))
    assert (got[..., 6:] == 0).all() and (got[..., :6] > 0).any()
    with pytest.raises(ValueError):
        te.tower_epilogue(y.double(), *tabs)
    with pytest.raises(ValueError):
        te.tower_epilogue(y[0], *tabs)
    with pytest.raises(ValueError):          # t of another height
        te.tower_epilogue(y, *tabs[:2], tabs[2][:, :4], *tabs[3:])
    with pytest.raises(ValueError):          # a table in another dtype
        te.tower_epilogue(y, tabs[0].to(torch.bfloat16), *tabs[1:])
    with pytest.raises(ValueError):
        te.tower_epilogue(y, *tabs, residual=res[:, :2])


# -- the CUDA kernel, emulated -----------------------------------------------

def _lane_walk(H, W, unroll=4):
    """The (element, h, w) each lane of a warp visits in one plane, as the
    kernel walks it: (h, w) from lane / W once, then advanced by 32
    elements with compares alone; loads past the plane are skipped."""
    seen = []
    for lane in range(32):
        h, w = lane // W, lane % W
        for e0 in range(lane, H * W, 32 * unroll):
            for u in range(unroll):
                e = e0 + 32 * u
                if e < H * W:
                    seen.append((e, h, w))
                w += 32
                while w >= W:
                    w -= W
                    h += 1
    return np.array(seen).reshape(-1, 3)


@pytest.mark.parametrize("H,W", [s[1:] for s in BLOCK_SHAPES]
                         + [(1, 3), (2, 40), (3, 32), (4, 33), (256, 1)])
def test_kernel_walk_visits_each_element_once_at_its_place(H, W):
    seen = _lane_walk(H, W)
    assert sorted(seen[:, 0]) == list(range(H * W))
    np.testing.assert_array_equal(seen[:, 1] * W + seen[:, 2], seen[:, 0])


def _to_bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def _kernel_emulation(y, a, b, t, f, mean, inv, beta, res, valid, bf16):
    """The kernel's arithmetic in numpy float32 over every (n, c, h, w):
    each add taken in float32 and held in the compute dtype, the
    BatchNorm in float32, the ReLU, zeros at w >= valid."""
    held = _to_bf16 if bf16 else (lambda v: v)
    f32 = [np.asarray(v.float(), np.float32) for v in
           (y, a, b, t, f, mean, inv, beta)]
    y, a, b, t, f, mean, inv, beta = f32
    x = held(y + a[:, :, None, None])
    x = held(x + b[:, :, None, None])
    x = held(x + t[None, :, :, None])
    x = held(x + f[None, :, None, :])
    if res is not None:
        x = held(x + np.asarray(res.float(), np.float32))
    x = held((x - mean[:, None, None]) * inv[:, None, None]
             + beta[:, None, None])
    x = np.where(np.isnan(x), x, np.maximum(x, np.float32(0)))
    if valid:
        x[..., valid:] *= np.float32(0)
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("valid", [0, 23])
def test_kernel_emulation_equals_plain_bit_for_bit(dtype, residual, valid):
    y, tabs, res = _tables(3, 8, 9, 29, dtype, seed=valid)
    res = res if residual else None
    plain = te.tower_epilogue_plain(y, *tabs, res, valid).float().numpy()
    emu = _kernel_emulation(y, *tabs, res, valid, dtype == torch.bfloat16)
    np.testing.assert_array_equal(emu.view(np.uint32), plain.view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_emulation_keeps_non_finite_values_as_plain(dtype):
    y, tabs, res = _tables(3, 8, 9, 29, dtype, seed=5)
    y = _non_finite(y, 23)
    with np.errstate(invalid="ignore"):
        emu = _kernel_emulation(y, *tabs, res, 23, dtype == torch.bfloat16)
    plain = te.tower_epilogue_plain(y, *tabs, res, 23).float().numpy()
    assert np.isnan(plain[..., 23:]).any()
    np.testing.assert_array_equal(emu, plain)


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BLOCK_SHAPES)
@pytest.mark.parametrize("N", [2048, 795, 1])
@pytest.mark.parametrize("residual", [False, True])
def test_kernel_equals_plain_on_card(shape, N, residual):
    """At every block's shape: a chunk of 2048 windows, a ragged tail and
    batch 1, with and without the residual."""
    _cuda()
    y, tabs, res = _tables(N, *shape, torch.float32, "cuda", seed=N)
    res = res if residual else None
    got = te.tower_epilogue(y, *tabs, residual=res)
    ref = te.tower_epilogue_plain(y, *tabs, res)
    assert torch.equal(_bits(got), _bits(ref))
    del y, tabs, res, got, ref
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,valid", [((64, 35, 256), 201),
                                         ((128, 18, 128), 101),
                                         ((512, 5, 32), 26)])
def test_kernel_equals_plain_on_card_padded_and_bfloat16(dtype, shape,
                                                         valid):
    _cuda()
    for residual in (False, True):
        y, tabs, res = _tables(37, *shape, dtype, "cuda", seed=valid)
        res = res if residual else None
        got = te.tower_epilogue(y, *tabs, residual=res, valid=valid)
        ref = te.tower_epilogue_plain(y, *tabs, res, valid)
        assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_keeps_non_finite_values_as_plain_on_card(dtype):
    _cuda()
    for residual in (False, True):
        y, tabs, res = _tables(37, 128, 18, 128, dtype, "cuda", seed=7)
        y = _non_finite(y, 101)
        res = res if residual else None
        got = te.tower_epilogue(y, *tabs, residual=res, valid=101)
        _same(got, te.tower_epilogue_plain(y, *tabs, res, 101))
        assert torch.isnan(got[..., 101:]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [2048, 795, 1])
def test_fused_tower_equals_the_modules_on_card(windows):
    """The shipped denoiser's residuals, the fused tower against the
    modules (grad on, no parameter needing it, TF32 off): in float32 the
    fused tower's convolutions are ops.tower_conv's, whose sums run in
    another order than cuDNN's, so max |diff| within chip_smoke's
    TOWER_RTOL of the modules' largest residual."""
    _cuda()
    from nhans_tpu_torch.compat.weights import load_npz

    model = NHANSNet(Config.denoiser().model)
    model.load_state_dict(load_npz(os.path.join(
        ROOT, "docs", "quality", "denoiser_q5_swa.npz")), strict=True)
    model = model.cuda().eval().requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(windows)
    x = torch.randn(windows, 35, 201, device="cuda", generator=g) * 2 - 4
    ea = torch.randn(windows, 512, device="cuda", generator=g)
    eb = torch.randn(windows, 512, device="cuda", generator=g)
    with torch.inference_mode():
        fused = model(x, emb_a=ea, emb_b=eb)
    with torch.enable_grad():
        ref = model(x, emb_a=ea, emb_b=eb)
    from chip_smoke import TOWER_RTOL

    diff = (fused - ref).abs().max().item()
    assert diff <= TOWER_RTOL * ref.abs().max().item()
