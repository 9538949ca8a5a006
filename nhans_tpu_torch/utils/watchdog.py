"""Stall watchdog and on-demand stack dumps for long-running loops;
the port's copy of ``nhans_tpu/utils/watchdog.py``.

A blocking device call that never returns (a lost card, a hung
collective) otherwise stops a run silently.

* :func:`install_stack_dump_signal` — ``kill -USR1 <pid>`` makes the
  process dump every thread's Python stack to stderr (faulthandler),
  without stopping it.  Installed by the training command line.
* :class:`Heartbeat` — a daemon thread that warns (and dumps all stacks)
  when the instrumented loop has not reported progress for ``timeout``
  seconds; it never kills the process by default.  Timeout override:
  ``NHANS_STALL_TIMEOUT`` (seconds).
* escalation (``abort_after`` / env ``NHANS_STALL_ABORT``, seconds,
  0 = off): ``os._exit(86)`` once a stall outlives it, so that a
  supervisor can restart the run, which auto-resumes from its last
  checkpoint.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import sys
import threading
import time

_DEFAULT_TIMEOUT = 900.0  # seconds


def install_stack_dump_signal(signum: int = signal.SIGUSR1) -> None:
    """Dump all thread stacks to stderr on ``signum`` (main thread only)."""
    if threading.current_thread() is threading.main_thread():
        faulthandler.register(signum, file=sys.stderr, all_threads=True)


class Heartbeat:
    """Progress heartbeat with a stall-warning daemon thread.

    >>> hb = Heartbeat(name="train loop"); hb.start()
    >>> hb.beat("step 42")   # call from the instrumented loop
    >>> hb.stop()

    When ``time since last beat > timeout`` the watchdog prints a
    diagnostic naming the last phase plus (optionally) all thread
    stacks, then re-arms, so a permanently hung process keeps shouting
    once per timeout period instead of dying quietly.
    """

    ABORT_EXIT_CODE = 86

    def __init__(self, name: str = "loop", timeout: float | None = None,
                 dump_stacks: bool = True, out=None,
                 abort_after: float | None = None):
        env = os.environ.get("NHANS_STALL_TIMEOUT", "")
        self.timeout = float(timeout if timeout is not None
                             else (env or _DEFAULT_TIMEOUT))
        aenv = os.environ.get("NHANS_STALL_ABORT", "")
        self.abort_after = float(abort_after if abort_after is not None
                                 else (aenv or 0.0))
        self.name = name
        self.dump_stacks = dump_stacks
        self.out = out if out is not None else sys.stderr
        self._last = time.monotonic()
        self._last_beat = self._last  # real progress only (abort clock);
        # _last also re-arms on warnings to pace the warn cadence
        self._phase = "startup"
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stall_count = 0  # total warnings emitted (tests/monitoring)

    def beat(self, phase: str = "") -> None:
        with self._lock:
            self._last = time.monotonic()
            self._last_beat = self._last
            if phase:
                self._phase = phase

    def start(self) -> "Heartbeat":
        if self.timeout <= 0 or self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._watch, name=f"watchdog[{self.name}]", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------------ #

    def _watch(self) -> None:
        poll = min(self.timeout / 4.0, 30.0)
        while not self._stop.wait(poll):
            with self._lock:
                now = time.monotonic()
                idle, phase = now - self._last, self._phase
                stalled = now - self._last_beat
            if idle <= self.timeout:
                continue
            self.stall_count += 1
            print(f"[watchdog] {self.name}: NO PROGRESS for {stalled:.0f}s "
                  f"(last phase: {phase}).  A blocking device call may be "
                  f"hung.  Checkpoints up to the last "
                  f"completed save are intact; auto-resume recovers this "
                  f"run.  `kill -USR1 {os.getpid()}` dumps stacks.",
                  file=self.out, flush=True)
            if self.dump_stacks:
                try:
                    faulthandler.dump_traceback(file=self.out,
                                                all_threads=True)
                except Exception:  # pragma: no cover - faulthandler quirk
                    pass
            if self.abort_after and stalled > self.abort_after:
                # a hung device call never returns; exit hard so a
                # supervisor can restart + auto-resume (module
                # docstring).  sys.exit would only kill this daemon
                # thread — the hung main thread needs os._exit.
                print(f"[watchdog] {self.name}: stall exceeded "
                      f"abort_after={self.abort_after:.0f}s — exiting "
                      f"{self.ABORT_EXIT_CODE} for supervised restart",
                      file=self.out, flush=True)
                try:
                    self.out.flush()
                except Exception:
                    pass
                os._exit(self.ABORT_EXIT_CODE)
            with self._lock:  # re-arm: warn once per timeout period
                self._last = time.monotonic()
