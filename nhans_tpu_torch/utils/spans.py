"""Spans and counts of the port's layers, on the profiler's clock.

    with spans.span("enhance.run", id=seq, windows=rows * frames):
        ...

A span records its name, its start and end as ``time.time_ns()`` (the
clock of the torch profiler's kineto timestamps), its parent (the span
open around it on the same thread), an ``id`` that ties together the
spans of one batch or one step, and integer counts, given when it opens
or added with ``count`` while it is open.  With a CUDA ``device`` it also
records a pair of timing events on the device's current stream; its
``device_ms`` waits for the second one and reads the time between them.

Spans are recorded while ``torch.profiler`` runs (``profiling()``) or
inside ``recording()``.  While the profiler runs, each span also opens a
``torch.profiler.record_function`` of its name, so the phases appear in
the Chrome traces that ``--profile_dir`` and ``tools/profile_*`` write.
Otherwise ``span`` tests one flag and returns a shared no-op: no clock,
no event, no allocation of its own.

Recorded spans are kept in a bounded ring of the process's newest
``RING`` spans; ``between`` reads those of a stretch of time and ``drain``
takes them all out.

The serving engine (``infer/enhance.py``) records, each with the batch's
sequence number as ``id``: ``enhance.dispatch`` (host preparation, count
``real_windows``: the frames of the real rows), ``enhance.launch`` (the
enqueue of the batch's device work) around ``enhance.contexts`` (the
context embeddings, from the cache or encoded) and ``enhance.run``
(counts ``windows``: the windows the tower computes, and
``skipped_windows``: the rest of the rows x bucket frames), and
``enhance.materialize`` (read-back and slicing).  The train step
(``train/step.py``) records ``train.step`` (``id`` the step number, on
the parameters' device) around ``train.batch``, ``train.forward``,
``train.backward`` and ``train.update``.  The trainer adds
``train.iteration`` (fetch and step, by device time ``step_device_ms``)
around ``train.fetch`` (the input wait).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# spans kept: the newest this many
RING = 65536


def profiling() -> bool:
    """Whether torch's profiler is running: the flag torch sets when a
    profile starts and clears when it stops, for ``with profile(...)``
    and ``.start()``/``.stop()`` alike."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One recorded span.  ``parent`` is the span open around it on its
    thread, or None; ``counts`` maps names to integers."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "counts",
                 "_events", "_device_ms", "_marker")

    def __init__(self, name: str, id, counts, device):
        self.name, self.id = name, id
        self.parent: Optional[Span] = None
        self.counts: Dict[str, int] = {k: int(v) for k, v in counts.items()}
        self.start_ns = self.end_ns = 0
        self._events = None
        self._device_ms: Optional[float] = None
        self._marker = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)

    def count(self, **counts) -> None:
        """Add to the span's counts while it is open."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds of the device's stream between the span's start and
        end, or None for a span without a CUDA device; waits for the
        device to reach the end."""
        if self._events is not None:
            start, end, _ = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms

    def __enter__(self) -> "Span":
        stack = _RECORDER.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        # the clock reads enclose the profiler's event and the device's
        self.start_ns = time.time_ns()
        if profiling():
            self._marker = torch.profiler.record_function(self.name)
            self._marker.__enter__()
        if self._events is not None:
            self._events[0].record(self._events[2])
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(self._events[2])
        if self._marker is not None:
            self._marker.__exit__(None, None, None)
            self._marker = None
        self.end_ns = time.time_ns()
        _RECORDER.close(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id!r}, "
                f"{self.host_ms:.3f} ms, counts={self.counts})")


class _Off:
    """The shared span returned while nothing records."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


OFF = _Off()


class _Recorder:
    """The process's ring of spans, the depth of ``recording()`` scopes
    and each thread's stack of open spans."""

    def __init__(self, size: int = RING):
        self.depth = 0
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=size)
        self._local = threading.local()

    def stack(self) -> list:
        """The calling thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def close(self, s: Span) -> None:
        stack = self.stack()
        if stack and stack[-1] is s:
            stack.pop()
        with self._lock:
            self._ring.append(s)

    @contextlib.contextmanager
    def recording(self):
        with self._lock:
            self.depth += 1
        try:
            yield
        finally:
            with self._lock:
                self.depth -= 1

    def between(self, t0_ns: int, t1_ns: int) -> List[Span]:
        with self._lock:
            found = [s for s in self._ring
                     if s.start_ns >= t0_ns and s.end_ns <= t1_ns]
        return sorted(found, key=lambda s: s.start_ns)

    def drain(self) -> List[Span]:
        with self._lock:
            found = list(self._ring)
            self._ring.clear()
        return sorted(found, key=lambda s: s.start_ns)


_RECORDER = _Recorder()


def span(name: str, id=None, device=None, **counts):
    """A context manager that records a span of ``name`` while recording
    is on (and yields it, for ``count``), else the shared no-op ``OFF``.
    ``device``: a CUDA device whose current stream the span also times."""
    if not (_RECORDER.depth or profiling()):
        return OFF
    return Span(name, id, counts, device)


def recording():
    """A scope in which spans are recorded, the profiler running or not;
    scopes may nest and overlap across threads."""
    return _RECORDER.recording()


def between(t0_ns: int, t1_ns: int) -> List[Span]:
    """The kept spans that lie within [t0_ns, t1_ns], by start."""
    return _RECORDER.between(t0_ns, t1_ns)


def drain() -> List[Span]:
    """Every kept span, by start, and the ring emptied."""
    return _RECORDER.drain()
