"""The optimizer's multi-tensor update (nhans_tpu_torch.ops.optimizer_update)
and ``Optimizer.apply`` (nhans_tpu_torch/train/optim.py).

On the CPU: three steps of ``apply`` (the plain version) equal today's
``update``, ``add_`` and squared sums of the global norm bit for bit, with
a tensor that has no gradient; the kernel's launch plan for the
separator's 393 tensors covers every value once; which rules take the
multi-tensor form; and the train step's ``train.update`` counts.  On the
card (marker ``gpu``): the kernel against today's dict arithmetic on the
card bit for bit at the 393 shapes, a null gradient and misaligned bases
included, the norm within 1e-6, at most 4 launches a step, the tensors it
refuses, and the counts of a step.  The machine with the card has no JAX:
this module imports none, and the card runs it with
``python -m pytest --noconftest -m gpu tests/test_torch_optimizer_update.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.nn.model import NHANSNet
from nhans_tpu_torch.ops import optimizer_update as ou
from nhans_tpu_torch.train import optim
from nhans_tpu_torch.train.optim import make_optimizer
from nhans_tpu_torch.train.step import make_train_step, make_tx, state_of
from nhans_tpu_torch.utils import spans
from tests.make_torch_golden import golden_train_inputs

ALGS = ["sgd", "momentum", "rmsprop", "adadelta", "adagrad", "adam"]
# odd sizes, a 4-D kernel, a tensor past one chunk, and "d" without a
# gradient
SHAPES = {"a": (7,), "b": (3, 5, 2, 3), "c": (ou.CHUNK + 13,), "d": (50,),
          "e": (1,)}
# the train step's narrow model (the Orbax fixtures' widths)
NARROW = dict(
    embedding_dim=1, pos_embed_hidden=2,
    main_blocks=((4, 1, 2), (4, 1, 2), (4, 2, 3), (4, 1, 3),
                 (3, 2, 2), (3, 1, 2), (3, 2, 3), (3, 1, 3)),
    context_blocks=(((8, 4), (3, 2), 2), ((8, 4), (3, 2), 3),
                    ((4, 4), (1, 1), 4), ((4, 4), (1, 2), 1)))


def _bits(x):
    return x.detach().view(torch.int32)


def _tensors(shapes, seed, device="cpu", scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(s, generator=g) * scale).to(device)
            for k, s in shapes.items()}


def _today(tx, params, grads, state, apart=()):
    """The update as the train step made it before ``apply``: missing
    gradients as zeros, the squared sums of the replicated tensors and of
    ``apart`` (``sum`` of ``torch.sum``s), the optimizer's update and the
    in-place add."""
    full = {k: grads[k] if k in grads else torch.zeros_like(p)
            for k, p in params.items()}
    rep = sum(torch.sum(g * g) for k, g in full.items() if k not in apart)
    blocks = sum(torch.sum(full[k] * full[k]) for k in apart)
    updates, state = tx.update(full, state)
    for k, p in params.items():
        p.add_(updates[k])
    return state, rep, blocks


def _steps(alg, params, seed, device):
    """Three steps' gradients for ``params`` on ``device``: "d" has none."""
    return [{k: g for k, g in _tensors({k: p.shape for k, p in
                                        params.items()}, seed + t,
                                       device).items() if k != "d"}
            for t in range(3)]


@pytest.mark.parametrize("apart", [(), ("b", "e")])
@pytest.mark.parametrize("alg", ["sgd", "adam"])
def test_apply_equals_update_add_and_norm_bit_for_bit(alg, apart):
    tx = make_optimizer(alg, 0.05)
    mine = _tensors(SHAPES, 0)
    ref = {k: p.clone() for k, p in mine.items()}
    s_mine = tx.init(mine)
    s_ref = tx.init(ref)
    for grads in _steps(alg, mine, 10, "cpu"):
        s_mine, sumsq = tx.apply(mine, grads, s_mine, apart=apart)
        s_ref, rep, blocks = _today(tx, ref, grads, s_ref, apart)
        assert s_mine["count"] == s_ref["count"]
        for k in SHAPES:
            assert torch.equal(_bits(mine[k]), _bits(ref[k])), k
            for slot in ("mu", "nu") if alg == "adam" else ():
                assert torch.equal(_bits(s_mine[slot][k]),
                                   _bits(s_ref[slot][k])), (slot, k)
        assert torch.equal(_bits(sumsq[0]), _bits(rep))
        assert float(sumsq[1]) == float(blocks)


def _separator_numels():
    with torch.device("meta"):
        model = NHANSNet(Config().model)
    return tuple(p.numel() for p in model.parameters())


def _block_ranges(numels, tensors, first, chunk=ou.CHUNK):
    """(tensor index, first value, end) of each block, found as the
    kernel finds it: a binary search for the last tensor whose first
    chunk is at or before the block."""
    out = []
    for b in range(first[-1]):
        lo, hi = 0, len(tensors)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if first[mid] <= b:
                lo = mid
            else:
                hi = mid
        begin = (b - first[lo]) * chunk
        out.append((tensors[lo], begin,
                    min(begin + chunk, numels[tensors[lo]])))
    return out


def test_the_launch_plan_covers_every_value_once():
    numels = _separator_numels()
    assert len(numels) == 393 and sum(numels) == 28980937
    assert sum(n < 4096 for n in numels) == 307
    padded = numels[:100] + (0,) + numels[100:]   # an empty tensor
    tensors, first = ou.launch_plan(padded)
    assert len(tensors) == 393 and 100 not in tensors
    seen = {i: [] for i in range(len(padded))}
    blocks = _block_ranges(padded, tensors, first)
    assert len(blocks) == first[-1] > 132 * 8
    for i, begin, end in blocks:
        assert 0 <= begin < end <= padded[i] and begin % 4 == 0
        assert end - begin <= ou.CHUNK
        seen[i].append((begin, end))
    for i, n in enumerate(padded):
        ranges = sorted(seen[i])
        covered = [0] + [e for _, e in ranges]
        assert [b for b, _ in ranges] == covered[:-1], i   # no gap, no overlap
        assert covered[-1] == n
    big = padded.index(4194304)
    assert len(seen[big]) == 4194304 // ou.CHUNK
    with pytest.raises(ValueError, match="at most 512"):
        ou.launch_plan((1,) * 513)


@pytest.mark.parametrize("alg", ALGS + ["replaced", "wrapped"])
def test_which_rules_take_the_multi_tensor_form(alg, monkeypatch):
    """sgd and adam go through the wrapper; the other rules, and an
    optimizer whose update was replaced, through ``update``, also where
    the replacement carries the rule's attributes over
    (``functools.wraps``)."""
    calls = []
    real = optim.optimizer_update

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(optim, "optimizer_update", counting)
    replaced = alg in ("replaced", "wrapped")
    tx = make_optimizer("adam" if replaced else alg, 0.05, 0.9)
    if replaced:
        real_update = tx.update
        new = lambda g, s: real_update(g, s)  # noqa: E731
        if alg == "wrapped":
            new = functools.wraps(real_update)(new)
            assert hasattr(new, "multi_tensor")
        tx = tx._replace(update=new)
    assert (tx.multi_tensor is not None) == (alg in ("sgd", "adam"))
    params = _tensors(SHAPES, 1)
    state = tx.init(params)
    before = {k: p.clone() for k, p in params.items()}
    state, sumsq = tx.apply(params, _steps(alg, params, 3, "cpu")[0], state)
    assert len(calls) == (1 if alg in ("sgd", "adam") else 0)
    assert state["count"] == 1 and sumsq.shape == (2,)
    assert not torch.equal(params["a"], before["a"])


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    params = _tensors(SHAPES, 2)
    grads = [params[k] * 0.5 for k in SHAPES]
    launches = ou.optimizer_update.launches
    sumsq = ou.optimizer_update(ou.Rule("sgd", -0.1), list(params.values()),
                                grads, groups=[0, 1, 0, 0, 1])
    assert ou.optimizer_update.launches == launches
    want = sum(float(torch.sum(g * g)) for i, g in enumerate(grads)
               if i not in (1, 4))
    assert float(sumsq[0]) == pytest.approx(want, rel=1e-6)
    with pytest.raises(ValueError, match="no rule"):
        ou.optimizer_update(ou.Rule("momentum", -0.1), [], [])
    with pytest.raises(ValueError, match="differ in length"):
        ou.optimizer_update(ou.Rule("adam", -0.1), list(params.values()),
                            grads)
    meta = [torch.empty(3, device="meta")]
    with pytest.raises(ValueError, match="no optimizer_update kernel"):
        ou.optimizer_update(ou.Rule("sgd", -0.1), meta, [None])


def test_the_rules_numbers_are_the_float32_the_operations_take():
    r = ou.Rule("adam", -0.001, c1=float(np.float32(0.1)),
                c2=float(np.float32(0.001)))
    f = r.floats()
    assert f.dtype == np.float32
    assert f[1] == np.float32(1 - 0.9) and f[3] == np.float32(1 - 0.999)
    assert f[5] == np.float32(1.0) / np.float32(0.1)
    assert f[6] == np.float32(1.0) / np.float32(0.001)
    assert f[7] == np.float32(1e-8)


def _narrow_step(alg, device):
    """A train step of the narrow model with ``alg`` on ``device``, spans
    recorded: (the ``train.update`` span, the parameters' value count)."""
    cfg = Config.denoiser()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **NARROW),
        data=dataclasses.replace(cfg.data, slices_per_step=2),
        train=dataclasses.replace(cfg.train, alg=alg, lr=1e-3, mom=0.9))
    torch.manual_seed(0)
    model = NHANSNet(cfg.model).to(device)
    tx = make_tx(cfg)
    state = state_of(model, tx)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in golden_train_inputs().items()}
    step = make_train_step(cfg, model, tx)
    spans.drain()
    with spans.recording():
        step(state, batch, torch.Generator().manual_seed(1))
    (update,) = [s for s in spans.drain() if s.name == "train.update"]
    return update, sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("alg", ALGS)
def test_the_update_span_counts_params_and_fused_params(alg):
    update, values = _narrow_step(alg, "cpu")
    assert update.counts == {"params": values, "fused_params": 0}
    assert values > 1000


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _separator_tensors(seed):
    """The separator's 393 parameter shapes on the card, random: a
    gradient left out, and a parameter and a gradient at bases 4 bytes
    past 16-byte alignment."""
    with torch.device("meta"):
        shapes = {k: p.shape for k, p in
                  NHANSNet(Config().model).named_parameters()}
    params = _tensors(shapes, seed, "cuda", 0.1)
    names = list(shapes)
    odd_p, odd_g, none = names[5], names[200], names[7]
    n = params[odd_p].numel()
    base = torch.empty(n + 1, device="cuda")
    params[odd_p] = base[1:].view(shapes[odd_p]).copy_(params[odd_p])
    assert params[odd_p].data_ptr() % 16 == 4
    steps = []
    for t in range(3):
        g = _tensors(shapes, seed + 1 + t, "cuda", 1e-2)
        del g[none]
        gbase = torch.empty(g[odd_g].numel() + 1, device="cuda")
        g[odd_g] = gbase[1:].view(shapes[odd_g]).copy_(g[odd_g])
        steps.append(g)
    return params, steps, names[:40:3]


def _kernels_launched(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA" and "Memcpy" not in e.name
             and "Memset" not in e.name]
    return out, names


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["sgd", "adam"])
def test_kernel_equals_todays_update_on_card(alg):
    """Three steps at the separator's 393 shapes: params, mu and nu bit
    for bit today's dict arithmetic and add_ on the card; the norm's two
    sums within 1e-6 relative; 2 launches a step."""
    _cuda()
    tx = make_optimizer(alg, 1e-3)
    mine, steps, apart = _separator_tensors(7)
    ref = {k: p.clone() for k, p in mine.items()}
    s_mine, s_ref = tx.init(mine), tx.init(ref)
    for grads in steps:
        launches = ou.optimizer_update.launches
        (s_mine, sumsq), kernels = _kernels_launched(
            lambda: tx.apply(mine, grads, s_mine, apart=apart))
        assert ou.optimizer_update.launches - launches == 2
        assert len(kernels) == 2 and all("optimizer_update" in k
                                         for k in kernels), kernels
        s_ref, rep, blocks = _today(tx, ref, grads, s_ref, apart)
        torch.cuda.synchronize()
        for k in mine:
            assert torch.equal(_bits(mine[k]), _bits(ref[k])), k
            for slot in ("mu", "nu") if alg == "adam" else ():
                assert torch.equal(_bits(s_mine[slot][k]),
                                   _bits(s_ref[slot][k])), (slot, k)
        assert float(sumsq[0]) == pytest.approx(float(rep), rel=1e-6)
        assert float(sumsq[1]) == pytest.approx(float(blocks), rel=1e-6)


@pytest.mark.gpu
def test_the_kernel_refuses_what_it_does_not_take():
    _cuda()
    rule = ou.Rule("sgd", -0.1)
    p = torch.zeros(8, 4, device="cuda")
    cases = [([p.t()], [None]),
             ([p], [torch.zeros(8, 4, device="cuda", dtype=torch.float64)]),
             ([p.to(torch.bfloat16)], [None]),
             ([p], [torch.zeros(33, device="cuda")])]
    for params, grads in cases:
        with pytest.raises(ValueError, match="contiguous float32"):
            ou.optimizer_update(rule, params, grads)
    with pytest.raises(ValueError, match="contiguous float32"):
        ou.optimizer_update(ou.Rule("adam", -0.1), [p], [None],
                            [torch.zeros(4, 8, device="cuda").t()],
                            [torch.zeros_like(p)])


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ALGS)
def test_a_step_on_the_card_counts_fused_params(alg):
    _cuda()
    update, values = _narrow_step(alg, "cuda")
    fused = values if alg in ("sgd", "adam") else 0
    assert update.counts == {"params": values, "fused_params": fused}
