"""The device trace of a short steady stretch, and what is read from it.

``Trace`` synchronises the card, starts ``torch.profiler`` with CUDA
activity only (no per-operator host events, whose cost would slow the
host path being measured), lets the driver run a few batches, calls or
steps, synchronises and stops.  The traced window is that stretch by the
host's clock; the device's intervals (kernels, copies, fills) come from
CUPTI, and the host's CUDA runtime calls, where CUPTI reports them, tell
what the host was doing in each idle gap, together with the driver's own
spans.  Timestamps are ``time.time_ns()`` nanoseconds, the profiler's
clock.

The table of kernel kinds is that of ``nhans_tpu_torch/tools/devtime.py``.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Tuple

# CUPTI reports its own buffer handling as rows of device time
CUPTI_ROWS = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request")
# kernel name fragments by kind, first match wins
KINDS = (("spectrogram kernel", ("log_spectrogram",)),
         ("convolution (cuDNN)", ("cudnn", "xmma", "implicit", "winograd",
                                  "fft", "conv", "sm90_", "cutlass",
                                  "gemm", "dgrad", "wgrad", "complex",
                                  "region_transform")),
         ("reduction", ("reduce", "Reduce")),
         ("elementwise and copies", ("elementwise", "Elementwise", "copy",
                                     "Copy", "fill", "Fill", "index",
                                     "Index", "gather", "Gather",
                                     "scatter", "cat", "pad", "Memcpy",
                                     "Memset")))

Span = Tuple[int, int, str]


def kind(name: str) -> str:
    for k, keys in KINDS:
        if any(key in name for key in keys):
            return k
    return "other"


class Trace:
    """Device intervals, host runtime calls and the driver's spans of one
    traced window [start_ns, end_ns]."""

    def __init__(self):
        self.device: List[Span] = []
        self.runtime: List[Span] = []
        self.spans: List[Span] = []
        self.start_ns = self.end_ns = 0
        self._prof = None

    # -- recording --------------------------------------------------------
    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        # the process's first session pays CUPTI's start-up: take it here
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self.start_ns = time.time_ns()

    @contextlib.contextmanager
    def span(self, label: str):
        """A span of the driver's own host work, for the gaps' labels."""
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), label))

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        self._prof.stop()
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if name in CUPTI_ROWS:
                continue
            item = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
            if str(e.device_type()).endswith("CUDA"):
                self.device.append(item)
            elif name.startswith("cuda"):
                self.runtime.append(item)
        self.device.sort()
        self.runtime.sort()
        self._prof = None

    # -- reading ----------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's intervals, clipped to the window."""
        out: List[List[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, fragment: str) -> float:
        """Summed device time of the operations whose name holds
        ``fragment``."""
        return sum(e - s for s, e, n in self.device if fragment in n) / 1e9

    def launches(self) -> int:
        """Kernels in the window (copies and fills are not launches)."""
        return sum(1 for _, _, n in self.device
                   if not n.startswith(("Memcpy", "Memset")))

    def gaps(self) -> List[Tuple[int, int]]:
        """Stretches of the window in which nothing ran on the device."""
        edges, at = [], self.start_ns
        for s, e in self.busy_intervals():
            if s > at:
                edges.append((at, s))
            at = max(at, e)
        if self.end_ns > at:
            edges.append((at, self.end_ns))
        return edges

    def host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the driver's innermost span and
        the CUDA runtime call it was in."""
        label = "no span of the driver"
        for s, e, n in self.spans:
            if s <= t < e:
                label = n
        call = "outside CUDA calls"
        for s, e, n in self.runtime:
            if s <= t < e:
                call = f"in {n}"
            if s > t:
                break
        return f"{label}, host {call}"


def device_busy(trace: Trace) -> dict:
    """The result line's ``busy_s`` and ``window_s``."""
    return {"busy_s": trace.busy_s(), "window_s": trace.window_s}


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device's time by kind of operation and then by the operations
    that took most, and the longest idle gaps by what the host was doing,
    in seconds over the traced window."""
    kinds, names = {}, {}
    for s, e, n in trace.device:
        k = kind(n)
        kinds[k] = kinds.get(k, 0.0) + (e - s) / 1e9
        names[n] = names.get(n, 0.0) + (e - s) / 1e9
    ops = [[f"kind: {k}", v] for k, v in sorted(kinds.items(),
                                                 key=lambda kv: -kv[1])]
    ops += [[f"op: {n[:120]}", v] for n, v in sorted(
        names.items(), key=lambda kv: -kv[1])[:max(top - len(ops), 0)]]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": ops[:top],
            "idle_gaps": [[trace.host_at((s + e) // 2), (e - s) / 1e9]
                          for s, e in gaps]}
