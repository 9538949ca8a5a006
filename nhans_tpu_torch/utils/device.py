"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
import os
import threading

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device to run on.  Entry points default to ``cuda``; a
    machine without a card must ask for ``cpu`` explicitly, so serving
    never carries on quietly on the CPU.  In a ``torch.distributed``
    world a bare ``cuda`` is the rank's own card, ``cuda:{LOCAL_RANK}``;
    a device with an index stays as given (ranks that share a card)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None
            and torch.distributed.is_initialized()):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU")
    return dev


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``.  A CPU tensor bound for a card is copied
    through pinned memory without blocking: a copy from pageable memory
    first waits for all the work queued on the stream, which would empty
    the card's queue in the middle of a train step."""
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _Float32Scope(contextlib.ContextDecorator):
    """TF32 off while any thread is inside: the flags are process-wide, so
    the first thread in saves and clears them and the last one out puts
    them back.  A thread that leaves while another is still inside (an
    evaluation on a thread of its own beside a train step) leaves them
    off."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    def __enter__(self):
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        with self._lock:
            if self._depth == 0:
                self._saved = cudnn.allow_tf32, matmul.allow_tf32
                cudnn.allow_tf32 = matmul.allow_tf32 = False
            self._depth += 1
        return self

    def __exit__(self, *exc):
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = self._saved
        return False


_FLOAT32 = _Float32Scope()


def full_float32() -> _Float32Scope:
    """TF32 off in cuDNN and in matmuls while serving, evaluation or a
    train step launches its device work, and the process's settings back
    afterwards; a context manager and a decorator.  The JAX reference
    takes its convolutions and DFTs in full float32 (Precision.HIGHEST);
    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits.  The flags are read when a kernel is launched,
    so work still running afterwards keeps them.  Scopes of several
    threads may overlap: the flags stay off until the last one ends."""
    return _FLOAT32
