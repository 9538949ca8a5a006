"""Timing of device work on the card, for the scripts that measure the
port there (``chip_smoke.py`` and the tools in this package).

``device_ms`` holds the stream with a sleep kernel while the host enqueues
the timed calls, so the events time the device alone.  (Events around
calls made back to back, the device idle at the first one, time the host
for a call shorter than its own host time.)  ``kernel_summary`` and
``print_kernels`` read a ``torch.profiler`` trace for the profiling
tools: the device time by kind of kernel and the kernels with the most.
"""

from __future__ import annotations

import subprocess
import time

import torch

# CUPTI reports its own buffer handling as rows of device time
_CUPTI_ROWS = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request")
# kernel name fragments by kind, first match wins
_KINDS = (("spectrogram kernel", ("log_spectrogram",)),
          ("tower epilogue kernel", ("tower_epilogue",)),
          ("tower convolution kernel", ("tower_conv",)),
          ("weight-gradient kernel", ("conv_wgrad",)),
          ("optimizer kernel", ("optimizer_update",)),
          ("convolution (cuDNN)", ("cudnn", "xmma", "implicit", "winograd",
                                   "fft", "conv", "sm90_", "cutlass",
                                   "gemm", "dgrad", "wgrad", "complex",
                                   "region_transform")),
          ("reduction", ("reduce", "Reduce")),
          ("elementwise and copies", ("elementwise", "Elementwise", "copy",
                                      "Copy", "fill", "Fill", "index",
                                      "Index", "gather", "Gather",
                                      "scatter", "cat", "pad")))


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_kind(name: str) -> str:
    for kind, keys in _KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def kernel_summary(prof, per: int = 1) -> dict:
    """The kernels of a trace (operator rows repeat their kernels' time;
    CUPTI's own rows and the device ranges of ``record_function`` spans
    are dropped), most device time first, and per ``per`` calls: the
    summed kernel time ``busy_ms``, the ``launches`` and the ms by kind
    of kernel."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in _CUPTI_ROWS
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    kinds = {}
    for e in rows:
        k = kernel_kind(e.key)
        kinds[k] = kinds.get(k, 0.0) + e.self_device_time_total / 1e3 / per
    return {"rows": rows, "per": per, "kinds": kinds,
            "busy_ms": sum(e.self_device_time_total for e in rows) / 1e3 / per,
            "launches": sum(e.count for e in rows) / per}


def print_kernels(summary: dict, top: int) -> None:
    """The ms by kind and the ``top`` kernels, each with its share of the
    summed kernel time."""
    busy, per = max(summary["busy_ms"], 1e-9), summary["per"]
    for k, ms in sorted(summary["kinds"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:24s} {ms:9.3f} ms {100 * ms / busy:5.1f}%")
    for e in summary["rows"][:top]:
        ms = e.self_device_time_total / 1e3 / per
        print(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  "
              f"x{e.count // per:<6d} {e.key[:100]}")


def sleep_cycles_per_ms():
    """Clock cycles of torch.cuda._sleep per ms on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    return 1e7 / start.elapsed_time(end)


def device_ms(fn, cycles_per_ms, reps=20, warmup=3, cold=False):
    """Mean device time of fn() in ms, and whether the host ran ahead.

    A sleep kernel holds the stream while the host enqueues the start
    event, reps calls and the end event, so the events time the device's
    work alone: the host ran ahead if the start event had not been reached
    when the last call was enqueued.  A call that synchronises inside
    (a copy from pageable host memory) cannot run ahead; its time is then
    paced by the host.  With ``cold``, each call follows a read of 128 MB
    that evicts the 50 MB L2 (and leaves it clean) and is timed by its own
    pair of events."""
    flush = torch.zeros(32 * 2 ** 20, dtype=torch.float32,
                        device="cuda") if cold else None
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(reps if cold else 1)]

    def run():
        if not cold:
            ev[0][0].record()
            for _ in range(reps):
                fn()
            ev[0][1].record()
            return
        for s, e in ev:
            flush.sum()
            s.record()
            fn()
            e.record()

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    for factor in (4, 16):
        torch.cuda._sleep(int((factor * host_ms + 1.0) * cycles_per_ms))
        run()
        ahead = not ev[0][0].query()
        torch.cuda.synchronize()
        if ahead:
            break
    return sum(s.elapsed_time(e) for s, e in ev) / reps, ahead
