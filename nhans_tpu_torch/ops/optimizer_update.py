"""The optimizer's update of every parameter tensor at once: the sgd and
Adam rules in place, and the gradients' squared sums for the global norm.
The CUDA kernel, its plain version and the wrapper that chooses between
them by device.

A step of ``train/optim.py``'s rules, done as PyTorch operations per
tensor and followed by an ``add_`` and the squares of the global norm,
issues about 17 kernels a tensor for Adam and 5 for sgd.  The kernel
(``csrc/optimizer_update.cu``) reads each gradient once, writes the
parameter and Adam's moments in place, with the rounding of those
operations so that its results equal theirs bit for bit, and leaves each
block's sum of squares in a slot of its own; a second launch adds the
slots in a fixed order.  The plain version is those operations, tensor
by tensor, written in place.

``rule_math`` is one tensor's update as those operations: the rules of
``train/optim.py`` and the plain version both call it, so the kernel is
held to one definition.  ``optimizer_update(rule, params, grads, ...)``
sends CPU tensors to the plain version and CUDA tensors to the kernel;
it never falls back from one to the other.  ``optimizer_update.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nhans_tpu_torch.ops import _build

# values a block updates: a multiple of 4, so that every chunk of an
# aligned tensor starts aligned
CHUNK = 16384
# the kernel's table (csrc/optimizer_update.cu, TensorTable): the tensors
# it takes at most, and its fields' offsets and types in bytes
MAX_TENSORS = 512
_M = MAX_TENSORS
TABLE_LAYOUT = (("ptrs", 0, np.uint64, 4 * _M),      # param, grad, mu, nu
                ("numel", 32 * _M, np.int64, _M),
                ("first", 40 * _M, np.int32, _M + 1),
                ("group", 44 * _M + 4, np.int32, _M),
                ("count", 48 * _M + 4, np.int32, 1))
TABLE_BYTES = 48 * _M + 8


@dataclasses.dataclass(frozen=True)
class Rule:
    """One update's rule: ``name`` "sgd" or "adam", ``step`` (-lr at this
    update), and Adam's decays, epsilon and bias corrections ``c1``,
    ``c2`` (float32 values, as optax takes them)."""
    name: str
    step: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    c1: float = 1.0
    c2: float = 1.0

    def floats(self) -> np.ndarray:
        """The kernel's 8 numbers, each the float32 that the PyTorch
        operation takes: a Python number is rounded to float32, and a
        tensor divided by one on the card is multiplied by its float32
        reciprocal."""
        f = np.float32
        return np.array([self.step, 1 - self.b1, self.b1, 1 - self.b2,
                         self.b2, f(1.0) / f(self.c1), f(1.0) / f(self.c2),
                         self.eps], np.float32)


def rule_math(rule: Rule, g: torch.Tensor, m: Optional[torch.Tensor] = None,
              v: Optional[torch.Tensor] = None) -> tuple:
    """One tensor's update by ``rule`` as PyTorch operations: (the update
    to add to the parameter, Adam's new ``m`` and ``v``; None and None for
    sgd).  The kernel's arithmetic equals these operations bit for bit."""
    if rule.name == "sgd":
        return rule.step * g, None, None
    m = (1 - rule.b1) * g + rule.b1 * m
    v = (1 - rule.b2) * g * g + rule.b2 * v
    return (rule.step * ((m / rule.c1) / (torch.sqrt(v / rule.c2) + rule.eps)),
            m, v)


def optimizer_update_plain(rule: Rule, params: Sequence[torch.Tensor],
                           grads: Sequence[Optional[torch.Tensor]],
                           mu: Sequence[torch.Tensor] = (),
                           nu: Sequence[torch.Tensor] = (),
                           groups: Sequence[int] = ()) -> torch.Tensor:
    """The plain version: ``rule_math`` per tensor, the parameter's
    ``add_``, and ``squared_sums``; a missing gradient is zeros."""
    grads = [g if g is not None else torch.zeros_like(p)
             for p, g in zip(params, grads)]
    sumsq = squared_sums(grads, groups)
    for i, (p, g) in enumerate(zip(params, grads)):
        if rule.name == "sgd":
            p.add_(rule_math(rule, g)[0])
        else:
            u, m, v = rule_math(rule, g, mu[i], nu[i])
            p.add_(u)
            mu[i].copy_(m)
            nu[i].copy_(v)
    return sumsq


def squared_sums(grads: Sequence[torch.Tensor],
                 groups: Sequence[int] = ()) -> torch.Tensor:
    """[2]: the sums of ``g * g`` over the tensors whose ``groups`` entry
    is 0 (all, when not given) and over those whose entry is 1, each
    added in the tensors' order (``sum`` of ``torch.sum``s)."""
    sums = [sum(torch.sum(g * g) for i, g in enumerate(grads)
                if bool(groups and groups[i]) == bool(k)) for k in (0, 1)]
    device = grads[0].device if grads else None
    return torch.stack([s if torch.is_tensor(s)
                        else torch.zeros((), device=device) for s in sums])


@functools.lru_cache(maxsize=16)
def launch_plan(numels: Tuple[int, ...], chunk: int = CHUNK
                ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The kernel's launch over tensors of ``numels``: the indices of the
    tensors that hold values, and ``first``, each one's first chunk, then
    the launch's chunk count.  A tensor's chunks are ``chunk`` values
    each, the last the rest; no chunk spans two tensors.  Block ``b``
    takes the last tensor whose first chunk is at or before ``b``."""
    tensors = tuple(i for i, n in enumerate(numels) if n)
    if len(tensors) > MAX_TENSORS:
        raise ValueError(f"optimizer_update takes at most {MAX_TENSORS} "
                         f"tensors, got {len(tensors)}")
    first = [0]
    for i in tensors:
        first.append(first[-1] + -(-numels[i] // chunk))
    return tensors, tuple(first)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib, _ = _build.load("optimizer_update")
    lib.nhans_optimizer_table_bytes.restype = ctypes.c_int64
    lib.nhans_optimizer_max_tensors.restype = ctypes.c_int
    if (lib.nhans_optimizer_max_tensors() != MAX_TENSORS
            or lib.nhans_optimizer_table_bytes() != TABLE_BYTES):
        raise RuntimeError("csrc/optimizer_update.cu's TensorTable does not "
                           "match the wrapper's TABLE_LAYOUT")
    update = lib.nhans_optimizer_update
    update.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    update.restype = ctypes.c_int
    norm = lib.nhans_optimizer_update_norm
    norm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]
    norm.restype = ctypes.c_int
    return update, norm


def _table() -> Tuple[np.ndarray, dict]:
    """A zeroed table and numpy views of its fields."""
    buf = np.zeros(TABLE_BYTES, np.uint8)
    views = {name: buf[at:at + np.dtype(dt).itemsize * n].view(dt)
             for name, at, dt, n in TABLE_LAYOUT}
    views["ptrs"] = views["ptrs"].reshape(4, MAX_TENSORS)
    return buf, views


def _check(what: str, t: torch.Tensor, device: torch.device,
           numel: int) -> None:
    if (t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != device or t.numel() != numel):
        raise ValueError(
            f"optimizer_update: {what} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}{'' if t.is_contiguous() else ', not contiguous'}; "
            f"the kernel takes contiguous float32 tensors of {numel} "
            f"values on {device}")


def optimizer_update(rule: Rule, params: Sequence[torch.Tensor],
                     grads: Sequence[Optional[torch.Tensor]],
                     mu: Sequence[torch.Tensor] = (),
                     nu: Sequence[torch.Tensor] = (),
                     groups: Sequence[int] = ()) -> torch.Tensor:
    """Update ``params`` in place by ``rule`` for ``grads`` (None: no
    gradient, read as zeros), Adam's moments ``mu`` and ``nu`` with them,
    and return the gradients' squared sums [2] of the tensors whose
    ``groups`` entry is 0 and 1 (all 0 when not given).  On a card the
    tensors are contiguous float32."""
    if rule.name not in ("sgd", "adam"):
        raise ValueError(f"optimizer_update has no rule {rule.name!r}")
    adam = rule.name == "adam"
    n = len(params)
    if (len(grads) != n or (adam and (len(mu) != n or len(nu) != n))
            or (groups and len(groups) != n)):
        raise ValueError("optimizer_update: params, grads, mu, nu and "
                         "groups differ in length")
    device = params[0].device if n else torch.device("cpu")
    if device.type == "cpu":
        return optimizer_update_plain(rule, params, grads, mu, nu, groups)
    if device.type != "cuda":
        raise ValueError(f"no optimizer_update kernel for device {device}")
    numels = tuple(p.numel() for p in params)
    for i, p in enumerate(params):
        _check(f"param {i}", p, device, numels[i])
        if grads[i] is not None:
            _check(f"grad {i}", grads[i], device, numels[i])
        if adam:
            _check(f"mu {i}", mu[i], device, numels[i])
            _check(f"nu {i}", nu[i], device, numels[i])
    tensors, first = launch_plan(numels)
    partials = torch.empty(2 * max(first[-1], 1), device=device)
    out = torch.empty(2, device=device)
    buf, view = _table()
    k = len(tensors)
    for row, col in enumerate([params, grads, mu, nu] if adam
                              else [params, grads]):
        view["ptrs"][row, :k] = [0 if col[i] is None else col[i].data_ptr()
                                 for i in tensors]
    view["numel"][:k] = [numels[i] for i in tensors]
    view["first"][:k + 1] = first
    if groups:
        view["group"][:k] = [1 if groups[i] else 0 for i in tensors]
    view["count"][0] = k
    floats = rule.floats()
    update, norm = _kernel_fns()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if k:
            err = update(int(adam), buf.ctypes.data, floats.ctypes.data,
                         CHUNK, partials.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"optimizer_update kernel launch failed: "
                                   f"cudaError {err}")
        err = norm(partials.data_ptr(), first[-1], out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"optimizer_update_norm kernel launch "
                               f"failed: cudaError {err}")
    optimizer_update.launches += int(k > 0) + 1
    return out


optimizer_update.launches = 0
