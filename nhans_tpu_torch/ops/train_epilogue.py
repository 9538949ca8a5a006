"""Training's epilogue after each of the towers' k x k convolutions:
conditioning, the residual, BatchNorm on the batch's moments and ReLU, its
forward and its backward.  The CUDA kernels, their plain version, the
wrappers that choose between them by device and the autograd function.

In training a ``CondResBlock`` (``nn/model.py``) follows each convolution
with ``Inject`` (four broadcast adds), after the second the residual add,
then ``BatchNorm`` on the batch's moments (which moves the population
statistics) and a ReLU, and in the lane-padded geometry multiplies the
columns past the true width by 0; a ``ContextBlock`` does the same without
the conditioning.  ``TrainEpilogue`` is all of it as one autograd function:

    v   = y + a[n, c] + b[n, c] + t[h, c] + f[w, c] (+ residual)
    out = relu((v - mean) * inv + beta),  times 0 at columns >= valid

with ``mean`` and ``var = E[v^2] - mean^2`` the batch's biased moments of
``v`` per channel, taken in float64, and ``inv = rsqrt(var + eps) *
gamma``.  The tables are laid out as their position MLPs give them: a, b
[N, C], t [H, C], f [W, C].  It saves ``v`` and the moments for the
backward, which is BatchNorm's (``csrc/train_epilogue.cu`` writes it out),
and returns the gradient of ``v`` for both ``y`` and the residual and each
table's as the sum of that gradient over its group.

The kernels (``csrc/train_epilogue.cu``) take every sum in float64 in a
fixed order, so that two runs on the same inputs agree bit for bit.  The
plain version is the same arithmetic in PyTorch operations, whose sums
take another order.  ``train_epilogue_forward`` and
``train_epilogue_backward`` send a CUDA tensor to the kernels and a CPU
tensor to the plain version; they never fall back from one to the
other.  Each counts the calls that
launched the kernels in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from nhans_tpu_torch.ops import _build

SMS = 132            # an H100's SMs
BLOCKS_PER_SM = 8    # blocks of 256 threads resident on one
SMEM_BYTES = 227 * 1024 - 1024  # a block's dynamic shared memory, at most

def epilogue_slices(n: int, c: int) -> Tuple[int, int]:
    """(slices, images a slice) of the sums over ``n`` images for ``c``
    channels: blocks of one channel and one slice enough to fill the card
    twice over, each slice at least one image."""
    per = -(-n // min(n, -(-2 * SMS * BLOCKS_PER_SM // c)))
    return -(-n // per), per


def _conditioned(y, residual, a, b, t, f):
    """v, added in the modules' order."""
    v = y
    if a is not None:
        v = (v + a[:, :, None, None] + b[:, :, None, None]
             + t.t()[None, :, :, None] + f.t()[None, :, None, :])
    return v if residual is None else v + residual


def _keep(x: torch.Tensor, valid: int) -> torch.Tensor:
    """1 at the columns below ``valid``, 0 beyond, in x's dtype."""
    return (torch.arange(x.shape[3], device=x.device) < valid).to(x.dtype)


def train_epilogue_forward_plain(y, residual, a, b, t, f, gamma, beta,
                                 pop_mean, pop_var, eps, decay, valid=0):
    """The plain forward: (out, v, mom), mom [3, C] float64 holding the
    float32 mean and inv and the float64 rstd; the population statistics
    moved in place unless ``pop_mean`` is None."""
    v = _conditioned(y, residual, a, b, t, f)
    v64 = v.double()
    count = v.numel() // v.shape[1]
    mean64 = v64.sum((0, 2, 3)) / count
    var64 = (v64 * v64).sum((0, 2, 3)) / count - mean64 * mean64
    rstd = 1.0 / torch.sqrt(var64 + eps)
    mean = mean64.float()
    inv = (rstd * gamma.double()).float()
    shape = (-1, 1, 1)
    out = F.relu((v - mean.view(shape)) * inv.view(shape)
                 + beta.view(shape))
    if valid:
        out = out * _keep(out, valid)
    if pop_mean is not None:
        with torch.no_grad():
            pop_mean.mul_(decay).add_((1 - decay) * mean)
            pop_var.mul_(decay).add_((1 - decay) * var64.float())
    return out, v, torch.stack([mean.double(), inv.double(), rstd])


def train_epilogue_backward_plain(dout, v, mom, gamma, beta, tables,
                                  valid=0):
    """The plain backward: (dv, da or None, dt, df, dgamma, dbeta); the
    table gradients where ``tables``."""
    N, C, H, W = v.shape
    shape = (-1, 1, 1)
    mean, inv, rstd = mom[0].float(), mom[1].float(), mom[2]
    xc = v - mean.view(shape)
    pre = xc * inv.view(shape) + beta.view(shape)
    inside = pre > 0
    if valid:
        inside = inside & (_keep(v, valid) > 0)
    dz = torch.where(inside, dout, torch.zeros_like(dout))
    dz64, xc64 = dz.double(), v.double() - mom[0].view(shape)
    count = N * H * W
    sdz = dz64.sum((0, 2, 3))
    sdzx = (dz64 * xc64).sum((0, 2, 3))
    A = gamma.double() * rstd
    B = -A * sdz / count
    K = A * rstd * rstd * sdzx / count
    dv = (A.float().view(shape) * dz
          + (B.float().view(shape) - K.float().view(shape) * xc))
    da = dt = df = None
    if tables:
        v64 = v.double()

        def group(sd, sv, g):   # sd, sv [C, ...]: channels first
            lead = (-1,) + (1,) * (sd.ndim - 1)
            return (A.view(lead) * sd + B.view(lead) * g
                    - K.view(lead) * (sv - g * mom[0].view(lead))).float()

        da = group(dz64.sum((2, 3)).t(), v64.sum((2, 3)).t(), H * W).t()
        dt = group(dz64.sum((0, 3)), v64.sum((0, 3)), N * W).t()
        df = group(dz64.sum((0, 2)), v64.sum((0, 2)), N * H).t()
        da, dt, df = da.contiguous(), dt.contiguous(), df.contiguous()
    return dv, da, dt, df, (rstd * sdzx).float(), sdz.float()


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib, _ = _build.load("train_epilogue")
    fwd = lib.nhans_train_epilogue_forward
    fwd.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                    + [ctypes.c_double, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.nhans_train_epilogue_backward
    bwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    smem = lib.nhans_train_epilogue_smem
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    return fwd, bwd, smem


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if (x.dtype != torch.float32 or tuple(x.shape) != tuple(shape)
            or x.device != device or not x.is_contiguous()):
        raise ValueError(f"train_epilogue: {name} is {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, expected "
                         f"contiguous float32 {tuple(shape)} on {device}")


def _checked(y, residual, a, b, t, f, gamma, beta):
    """The shapes, types and devices the kernels take, or ValueError."""
    if y.dtype != torch.float32 or y.ndim != 4:
        raise ValueError("train_epilogue takes a 4-D float32 tensor, got "
                         f"{y.dtype} {tuple(y.shape)}")
    N, C, H, W = y.shape
    if min(N, C, H, W) < 1 or N * H * W >= 2 ** 31:
        raise ValueError(f"train_epilogue: shape {tuple(y.shape)} is "
                         "beyond the kernels")
    tables = [x is None for x in (a, b, t, f)]
    if any(tables) and not all(tables):
        raise ValueError("train_epilogue takes all four tables or none")
    checks = [("y", y, (N, C, H, W)), ("gamma", gamma, (C,)),
              ("beta", beta, (C,))]
    if residual is not None:
        checks.append(("residual", residual, (N, C, H, W)))
    if a is not None:
        checks += [("a", a, (N, C)), ("b", b, (N, C)), ("t", t, (H, C)),
                   ("f", f, (W, C))]
    for name, x, shape in checks:
        _check(name, x, shape, y.device)


def train_epilogue_forward(y, residual, a, b, t, f, gamma, beta, pop_mean,
                           pop_var, eps: float, decay: float,
                           valid: int = 0):
    """(out, v, mom) of the epilogue's forward: y and ``residual`` (or
    None) [N, C, H, W]; a, b [N, C], t [H, C], f [W, C] (or all None);
    gamma, beta, pop_mean and pop_var [C]; all float32 and contiguous on
    one device.  The population statistics move in place unless
    ``pop_mean`` is None.  ``valid`` 0: no column masked."""
    _checked(y, residual, a, b, t, f, gamma, beta)
    if pop_mean is not None:
        _check("pop_mean", pop_mean, gamma.shape, y.device)
        _check("pop_var", pop_var, gamma.shape, y.device)
    if y.device.type != "cuda":
        if y.device.type != "cpu":
            raise ValueError(f"no train_epilogue kernel for device "
                             f"{y.device}")
        return train_epilogue_forward_plain(y, residual, a, b, t, f, gamma,
                                            beta, pop_mean, pop_var, eps,
                                            decay, valid)
    N, C, H, W = y.shape
    S, per = epilogue_slices(N, C)
    v = torch.empty_like(y)
    out = torch.empty_like(y)
    mom = torch.empty((3, C), dtype=torch.float64, device=y.device)
    ws = torch.empty(S * C * 2, dtype=torch.float64, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fns()[0](
            y.data_ptr(), _ptr(residual), _ptr(a), _ptr(b), _ptr(t), _ptr(f),
            gamma.data_ptr(), beta.data_ptr(), _ptr(pop_mean),
            _ptr(pop_var), v.data_ptr(), out.data_ptr(), mom.data_ptr(),
            ws.data_ptr(), N, C, H, W, valid or W, S, per, eps, decay,
            1 - decay, stream)
    if err != 0:
        raise RuntimeError(f"train_epilogue forward launch failed: "
                           f"cudaError {err}")
    train_epilogue_forward.launches += 1
    return out, v, mom


train_epilogue_forward.launches = 0


def train_epilogue_backward(dout, v, mom, gamma, beta, tables: bool,
                            valid: int = 0):
    """(dv, da, dt, df, dgamma, dbeta) of the epilogue from its output's
    gradient ``dout`` and what the forward saved (``v``, ``mom``); da
    [N, C], dt [H, C] and df [W, C] where ``tables``, else None."""
    N, C, H, W = v.shape
    _check("dout", dout, v.shape, v.device)
    if v.device.type != "cuda":
        return train_epilogue_backward_plain(dout, v, mom, gamma, beta,
                                             tables, valid)
    S, per = epilogue_slices(N, C)
    _, bwd, smem = _kernel_fns()
    if tables and smem(H, W) > SMEM_BYTES:
        raise ValueError(f"train_epilogue: a plane of {H} x {W} does not "
                         "fit the backward's shared memory")
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=v.device)
    dv = torch.empty_like(v)
    dgamma, dbeta = new(C), new(C)
    da, dt, df = (new(N, C), new(H, C), new(W, C)) if tables else (None,) * 3
    size = S * C * 2 + 3 * C + (N * C * 2 + S * C * 2 * (H + W)
                                if tables else 0)
    ws = torch.empty(size, dtype=torch.float64, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = bwd(dout.data_ptr(), v.data_ptr(), mom.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), dv.data_ptr(),
                  dgamma.data_ptr(), dbeta.data_ptr(), _ptr(da), _ptr(dt),
                  _ptr(df), ws.data_ptr(), N, C, H, W, valid or W, S, per,
                  stream)
    if err != 0:
        raise RuntimeError(f"train_epilogue backward launch failed: "
                           f"cudaError {err}")
    train_epilogue_backward.launches += 1
    return dv, da, dt, df, dgamma, dbeta


train_epilogue_backward.launches = 0


class TrainEpilogue(torch.autograd.Function):
    """``relu(BatchNorm(y + a + b + t + f [+ residual]))`` in training,
    the columns at ``valid`` and beyond times 0: ``bn`` a
    ``nn.blocks.BatchNorm`` in training, whose population statistics move
    unless its ``update_stats`` is False; ``gamma`` and ``beta`` its
    parameters (passed apart for their gradients)."""

    @staticmethod
    def forward(ctx, y, residual, a, b, t, f, gamma, beta, bn, valid):
        update = bn.update_stats
        dense = [x if x is None else x.contiguous()
                 for x in (y, residual, a, b, t, f)]
        out, v, mom = train_epilogue_forward(
            *dense, gamma, beta, bn.pop_mean if update else None,
            bn.pop_variance if update else None, bn.eps, bn.decay, valid)
        ctx.tables, ctx.residual, ctx.valid = (
            a is not None, residual is not None, valid)
        ctx.save_for_backward(v, mom, gamma, beta)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        v, mom, gamma, beta = ctx.saved_tensors
        dv, da, dt, df, dgamma, dbeta = train_epilogue_backward(
            dout.contiguous(), v, mom, gamma, beta, ctx.tables, ctx.valid)
        return (dv, dv if ctx.residual else None, da, da, dt, df, dgamma,
                dbeta, None, None)
