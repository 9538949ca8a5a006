"""Timing of device work with CUDA events, for the scripts that measure
the port on the card (``chip_smoke.py``, ``tools/spectrogram_anatomy.py``).

``device_ms`` holds the stream with a sleep kernel while the host enqueues
the timed calls, so the events time the device alone; ``host_paced_ms``
is the earlier method (events around calls made back to back), which for
a call shorter than its own host time measures the host.  It is kept for
one slice only, so that the spectrogram kernel's first device times can
be set beside the host-paced ones they replace; the next slice removes
it, with its use in ``chip_smoke.py``.
"""

from __future__ import annotations

import time

import torch


def host_paced_ms(fn, reps=20, warmup=3):
    """Mean time of fn() in ms by CUDA events around reps calls made back
    to back, the device idle at the first event.  Where a call enqueues
    its work faster than the host makes the next call, this is the host's
    time, not the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
