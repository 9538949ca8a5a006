"""Training's epilogue on the hand-written kernels
(nhans_tpu_torch.ops.train_epilogue and the routing of
nn/model.py::_train_epilogue).

On the CPU, at narrow widths and few windows: ``TrainEpilogue``'s plain
version against the modules (``Inject``'s adds, the residual add,
``BatchNorm`` in training, the ReLU and the lane-padded mask) in its
forward, in the gradients of y, the residual, the four tables, gamma and
beta, and in the population statistics, with and without
``update_stats``; the slices of its sums; the wrappers' refusals; and the
routing, which sends the 24 epilogues after both towers' k x k
convolutions to the function only with grad on, a BatchNorm in training
without a data group, float32 and a kernel device (the CPU let through
here), with the modules' loss, gradients and statistics, and never moves
the serving epilogue.  On the card (marker ``gpu``): the kernels against
the plain version at the towers' 24 output shapes, bit for bit from run to
run, and 24 epilogues on the kernels in a full-width step.  The machine
with the card has no JAX: this module imports none, and the card runs it
with ``python -m pytest --noconftest -m gpu
tests/test_torch_train_epilogue.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.nn import model as nn_model
from nhans_tpu_torch.nn.blocks import BatchNorm, frozen_stats
from nhans_tpu_torch.nn.model import (NHANSNet, freq_weighted_mse,
                                      hand_epilogues)
from nhans_tpu_torch.ops import tower_epilogue as tep
from nhans_tpu_torch.ops import train_epilogue as te


def _inputs(N, C, H, W, tables, residual, seed, device="cpu"):
    """y, residual, a, b, t, f and a BatchNorm in training with random
    gamma, beta and population statistics."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(device)

    y = rand(N, C, H, W, scale=2.0, shift=0.5)
    r = rand(N, C, H, W) if residual else None
    tabs = ((rand(N, C), rand(N, C), rand(H, C, scale=0.3),
             rand(W, C, scale=0.3)) if tables else (None,) * 4)
    bn = BatchNorm(C).to(device).train()
    with torch.no_grad():
        bn.gamma.copy_(rand(C, scale=0.5, shift=1.0))
        bn.beta.copy_(rand(C, scale=0.5))
        bn.pop_mean.copy_(rand(C))
        bn.pop_variance.copy_(rand(C).abs() + 0.5)
    return y, r, tabs, bn


def _modules(y, r, tabs, bn, valid):
    a, b, t, f = tabs
    v = y
    if a is not None:   # Inject's adds, with its broadcasts
        v = (v + a[:, :, None, None] + b[:, :, None, None]
             + t.t()[None, :, :, None] + f.t()[None, :, None, :])
    if r is not None:
        v = v + r
    return nn_model._keep_columns(F.relu(bn(v)), valid)


def _run(fn, y, r, tabs, bn, valid, dout):
    """The output, the gradients of every input and the statistics after
    ``fn``, from clones of the inputs."""
    leaves = [x.clone().requires_grad_() if x is not None else None
              for x in (y, r) + tuple(tabs)]
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    bn.zero_grad(set_to_none=True)
    out = fn(leaves[0], leaves[1], tuple(leaves[2:]), bn, valid)
    out.backward(dout)
    grads = [None if x is None else x.grad for x in leaves]
    got = (out.detach(), grads, bn.gamma.grad.clone(), bn.beta.grad.clone(),
           bn.pop_mean.clone(), bn.pop_variance.clone())
    bn.load_state_dict(state)
    return got


def _function(y, r, tabs, bn, valid):
    return te.TrainEpilogue.apply(y, r, *tabs, bn.gamma, bn.beta, bn, valid)


def _close(got, want, rel=2e-5):
    """Within float32 round-off of the modules: by norm, against the
    larger of the reference's norm and its largest entry's size."""
    assert got.shape == want.shape
    scale = max(torch.linalg.vector_norm(want).item(),
                want.abs().max().item(), 1e-30)
    gap = torch.linalg.vector_norm(got - want).item()
    assert gap <= rel * scale, (gap, scale)


@pytest.mark.parametrize("tables,residual,valid", [
    (True, False, 0), (True, True, 0), (False, False, 0), (False, True, 0),
    (True, False, 9), (True, True, 11)])
@pytest.mark.parametrize("update", [True, False])
def test_plain_function_is_the_modules(tables, residual, valid, update):
    """Forward, every gradient and the population statistics of the
    function's plain version equal the modules' within float32 round-off;
    with ``update_stats`` False neither moves the statistics."""
    y, r, tabs, bn, = _inputs(3, 5, 6, 13, tables, residual, seed=valid)
    dout = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
    before = (bn.pop_mean.clone(), bn.pop_variance.clone())
    bn.update_stats = update
    got = _run(_function, y, r, tabs, bn, valid, dout)
    want = _run(_modules, y, r, tabs, bn, valid, dout)
    _close(got[0], want[0])
    if valid:
        assert (got[0][..., valid:] == 0).all()
    names = ["y", "residual", "a", "b", "t", "f"]
    for name, g, w in zip(names, got[1], want[1]):
        assert (g is None) == (w is None), name
        if w is not None:
            _close(g, w)
    _close(got[2], want[2])
    _close(got[3], want[3])
    for g, w, b in zip(got[4:], want[4:], before):
        torch.testing.assert_close(g, w, rtol=2e-6, atol=2e-7)
        assert torch.equal(g, b) != update


def test_plain_moments_are_float64s():
    """The mean and rstd come from float64 sums, also on channels whose
    mean is far from 0, and the backward's dgamma and dbeta are the
    float64 sums rounded."""
    y, _, _, bn = _inputs(4, 3, 8, 9, False, False, seed=3)
    y = y + 300.0
    out, v, mom = te.train_epilogue_forward(
        y, None, None, None, None, None, bn.gamma.detach(),
        bn.beta.detach(), None, None, bn.eps, bn.decay)
    y64 = y.double()
    mean = y64.mean((0, 2, 3))
    var = y64.var((0, 2, 3), unbiased=False)
    assert torch.equal(mom[0], mean.float().double())
    torch.testing.assert_close(mom[2], 1 / torch.sqrt(var + bn.eps),
                               rtol=1e-12, atol=0)
    dout = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    dz = torch.where((v - mom[0].float().view(-1, 1, 1))
                     * mom[1].float().view(-1, 1, 1)
                     + bn.beta.detach().view(-1, 1, 1) > 0, dout, 0.0)
    _, _, _, _, dgamma, dbeta = te.train_epilogue_backward(
        dout, v, mom, bn.gamma.detach(), bn.beta.detach(), False)
    assert torch.equal(dbeta, dz.double().sum((0, 2, 3)).float())
    xhat = (v.double() - mom[0].view(-1, 1, 1)) * mom[2].view(-1, 1, 1)
    torch.testing.assert_close(dgamma, (dz.double() * xhat).sum(
        (0, 2, 3)).float(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,c", [(64, 64), (64, 128), (64, 256), (64, 512),
                                 (3, 4), (1, 2048), (200, 1)])
def test_slices_cover_the_images(n, c):
    """Every image in one slice of at least one image; the blocks fill
    the card twice where the shapes allow."""
    S, per = te.epilogue_slices(n, c)
    assert per >= 1 and S * per >= n > (S - 1) * per
    assert S * c >= min(2 * te.SMS * te.BLOCKS_PER_SM, n * c) // 2


def test_wrappers_refuse_what_the_kernels_do_not_take():
    y, r, (a, b, t, f), bn = _inputs(2, 3, 4, 5, True, True, seed=0)
    g, be = bn.gamma.detach(), bn.beta.detach()
    bad = [
        (y.double(), r, a, b, t, f),
        (y[0], r, a, b, t, f),
        (y.transpose(2, 3), r, a, b, t, f),
        (y, r[:, :2], a, b, t, f),
        (y, r, a, None, t, f),
        (y, r, a, b, t.t(), f),
        (y, r, a, b, t, f[:4]),
        (y, r, a[:1], b, t, f),
        (y, r, a, b.to(torch.bfloat16), t, f),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            te.train_epilogue_forward(*args, g, be, None, None, 1e-3, 0.95)
    with pytest.raises(ValueError):
        te.train_epilogue_forward(y, r, a, b, t, f, g[:2], be, None, None,
                                  1e-3, 0.95)


# -- the routing -------------------------------------------------------------

def _layout_model(dtype="float32", seed=0, **model):
    """The separator's blocks, kernels and strides at narrow widths and 40
    context frames."""
    sep = Config.separator().model
    main = tuple((k, s, c // 32) for k, s, c in sep.main_blocks)
    ctx = tuple((k, s, c // 32) for k, s, c in sep.context_blocks)
    cfg = dataclasses.replace(sep, main_blocks=main, context_blocks=ctx,
                              context_frames=40, embedding_dim=6,
                              pos_embed_hidden=5, compute_dtype=dtype,
                              **model)
    torch.manual_seed(seed)
    net = NHANSNet(cfg)
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0.0, 0.3)
    return net.train(), cfg


def _step(net, cfg, seed=1):
    """One training forward and backward on 3 random windows: the loss, the
    gradients, the statistics after it and the BatchNorms whose epilogues
    took the function."""
    g = torch.Generator().manual_seed(seed)
    W, C, F_ = cfg.window_frames, cfg.context_frames, cfg.num_features
    mixed = torch.randn(3, W, F_, generator=g) - 4
    ctx = [torch.randn(3, C, F_, generator=g) - 4 for _ in range(2)]
    target = mixed[:, W // 2] + 0.1 * torch.randn(3, F_, generator=g)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    net.zero_grad(set_to_none=True)
    with hand_epilogues() as seen:
        res = net(mixed, *ctx)
        loss, _ = freq_weighted_mse(mixed[:, W // 2] + res, target)
    loss.backward()
    names = {m: k for k, m in net.named_modules()}
    out = ({k: p.grad.clone() for k, p in net.named_parameters()},
           {k: v.clone() for k, v in net.state_dict().items()
            if "pop_" in k}, loss.detach(), sorted(names[m] for m in seen))
    net.load_state_dict(state)
    return out


def _modules_only(monkeypatch):
    monkeypatch.setattr(nn_model, "_train_epilogue",
                        nn_model._epilogue_modules)


def _let_cpu_through(monkeypatch):
    monkeypatch.setattr(nn_model, "KERNEL_DEVICES", ("cuda", "cpu"))


def _same_step(got, want, rel=1e-4):
    grads, stats, loss, _ = got
    want_grads, want_stats, want_loss, _ = want
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    norms = {k: torch.linalg.vector_norm(v).item()
             for k, v in want_grads.items()}
    med = float(np.median(list(norms.values())))
    for k in want_grads:
        gap = torch.linalg.vector_norm(grads[k] - want_grads[k]).item()
        assert gap <= rel * max(norms[k], med), k
    for k in want_stats:
        torch.testing.assert_close(stats[k], want_stats[k], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("pad", [0, 256])
def test_routing_sends_the_24_epilogues_with_the_modules_step(monkeypatch,
                                                              pad):
    """With the CPU let through, the BatchNorms after the 24 k x k
    convolutions (bn1 and bn_out of the 8 main and 4 context blocks) take
    the function, and no other (the position MLPs' and the head's keep the
    modules); loss, gradients and statistics equal the modules' within
    float32 round-off, in the native and the lane-padded geometry."""
    net, cfg = _layout_model(freq_pad_to=pad)
    with monkeypatch.context() as m:
        _modules_only(m)
        _let_cpu_through(m)
        want = _step(net, cfg)
    assert want[3] == []
    _let_cpu_through(monkeypatch)
    got = _step(net, cfg)
    expect = sorted([f"resblock{i}.{bn}" for i in range(1, 9)
                     for bn in ("bn1", "bn_out")]
                    + [f"embedding.block{i}.{bn}" for i in range(1, 5)
                       for bn in ("bn1", "bn_out")])
    assert got[3] == expect and len(expect) == 24
    _same_step(got, want)


def test_routing_keeps_the_modules_elsewhere(monkeypatch):
    """On the CPU as it stands, in bfloat16, with a data group, for a
    BatchNorm in inference with grad on, and with grad off, the modules
    run: nothing takes the function and the step is today's bit for bit;
    the serving epilogue never runs in training."""
    net, cfg = _layout_model()
    launches = tep.tower_epilogue.launches
    got = _step(net, cfg)
    with monkeypatch.context() as m:
        _modules_only(m)
        want = _step(net, cfg)
    assert got[3] == []
    assert torch.equal(got[2], want[2])
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    _let_cpu_through(monkeypatch)
    bf16, bcfg = _layout_model("bfloat16")
    assert _step(bf16, bcfg)[3] == []
    assert _step(net, cfg)[3] and tep.tower_epilogue.launches == launches
    bn = net.resblock3.bn1
    y = torch.randn(2, bn.gamma.shape[0], 5, 7)
    monkeypatch.setattr(nn_model, "_epilogue_modules",
                        lambda *args, **kw: "modules")

    def route(**grad):
        with torch.set_grad_enabled(grad.get("on", True)), \
                hand_epilogues() as seen:
            out = nn_model._train_epilogue(bn, y)
        assert (out == "modules") == (not seen)
        return "kernels" if seen else out

    assert route() == "kernels"
    assert route(on=False) == "modules"
    bn.group = object()          # a data group: the global moments
    assert route() == "modules"
    bn.group = None
    bn.eval()
    assert route() == "modules"
    bn.train()
    assert route() == "kernels"


def test_frozen_stats_hold_on_the_function(monkeypatch):
    """Remat's recomputation runs inside ``frozen_stats``: the function
    then leaves the statistics alone, as the modules do."""
    _let_cpu_through(monkeypatch)
    net, cfg = _layout_model()
    before = {k: v.clone() for k, v in net.state_dict().items()
              if "pop_" in k}
    with frozen_stats(net):
        stats = _step(net, cfg)[1]
    for k in before:
        assert torch.equal(stats[k], before[k]), k
    remat, rcfg = _layout_model(remat=True)
    plain_net, pcfg = _layout_model()
    _same_step(_step(remat, rcfg), _step(plain_net, pcfg), rel=1e-6)


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# the 24 epilogues of a 64-window step: (name, N, C, H, W, tables,
# residual, calls) of each, from the convolutions they follow
SHAPES = chip_smoke.epilogue_shapes(Config.separator().model)


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(SHAPES)),
                         ids=[s[0] for s in SHAPES])
def test_kernels_against_the_plain_version_on_card(i):
    """At each of the 24 output shapes of a 64-window step: the kernels'
    forward and backward against the plain version on the same card
    tensors (the same arithmetic with sums in another order), the
    statistics moved, and two runs equal bit for bit."""
    _cuda()
    name, N, C, H, W, tables, residual, _ = SHAPES[i]
    y, r, tabs, bn = _inputs(N, C, H, W, tables, residual, seed=300 + i,
                             device="cuda")
    g, be = bn.gamma.detach(), bn.beta.detach()
    dout = torch.randn(y.shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(i))
    pops = [(bn.pop_mean.clone(), bn.pop_variance.clone()) for _ in range(3)]

    def kernels(pm, pv):
        before = (te.train_epilogue_forward.launches,
                  te.train_epilogue_backward.launches)
        fwd = te.train_epilogue_forward(y, r, *tabs, g, be, pm, pv, bn.eps,
                                        bn.decay)
        bwd = te.train_epilogue_backward(dout, fwd[1], fwd[2], g, be,
                                         tables)
        torch.cuda.synchronize()
        assert (te.train_epilogue_forward.launches,
                te.train_epilogue_backward.launches) == (before[0] + 1,
                                                         before[1] + 1)
        return fwd, bwd

    first, again = kernels(*pops[0]), kernels(*pops[1])
    for x, z in zip(first[0] + first[1] + pops[0],
                    again[0] + again[1] + pops[1]):
        assert (x is None and z is None) or torch.equal(x, z), name
    fwd = te.train_epilogue_forward_plain(y, r, *tabs, g, be, *pops[2],
                                          bn.eps, bn.decay)
    bwd = te.train_epilogue_backward_plain(dout, fwd[1], fwd[2], g, be,
                                           tables)
    assert torch.equal(first[0][1], fwd[1]), name      # v: the same adds
    torch.testing.assert_close(first[0][2], fwd[2], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(first[0][0], fwd[0], rtol=1e-6, atol=1e-6)
    for x, z in zip(pops[0], pops[2]):
        torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-7)
    for x, z in zip(first[1], bwd):
        assert (x is None) == (z is None)
        if z is not None:
            _close(x, z, rel=1e-5)


@pytest.mark.gpu
def test_full_step_takes_24_epilogues_on_card():
    """The separator at full width, 64 windows, from the shipped weights:
    24 epilogues take the kernels, and every leaf's gradient lies within
    STEP_GRAD_GAP of the modules' (TF32 off), relative to the larger of the
    leaf's norm and the median leaf's."""
    import os

    from nhans_tpu_torch.compat.weights import load_npz

    _cuda()
    cs = chip_smoke
    weights = load_npz(os.path.join(cs.REPO, "docs", "quality",
                                    "separator_q5_swa.npz"))
    cfg = Config.separator().model
    net = NHANSNet(cfg)
    net.load_state_dict(weights)
    net = net.to("cuda").train()
    state = {k: v.clone() for k, v in net.state_dict().items()}
    g = torch.Generator(device="cuda").manual_seed(24)
    W, C, F_ = cfg.window_frames, cfg.context_frames, cfg.num_features
    mixed = torch.randn(64, W, F_, generator=g, device="cuda") - 4
    ctx = [torch.randn(64, C, F_, generator=g, device="cuda") - 4
           for _ in range(2)]
    target = mixed[:, W // 2] + 0.1 * torch.randn(64, F_, generator=g,
                                                  device="cuda")

    def run():
        net.load_state_dict(state)
        net.zero_grad(set_to_none=True)
        with hand_epilogues() as seen:
            loss, _ = freq_weighted_mse(
                mixed[:, W // 2] + net(mixed, *ctx), target)
        loss.backward()
        return ({k: p.grad.detach().clone()
                 for k, p in net.named_parameters()}, len(seen))

    real = nn_model._train_epilogue
    try:
        hand, count = run()
        nn_model._train_epilogue = nn_model._epilogue_modules
        modules, none = run()
    finally:
        nn_model._train_epilogue = real
    assert count == 24 and none == 0
    gaps = cs.leaf_gaps(hand, modules)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= cs.STEP_GRAD_GAP, (worst, gaps[worst])
