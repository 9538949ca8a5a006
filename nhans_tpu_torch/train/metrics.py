"""Training metrics: a JSONL record and a TensorBoard event file under
``--summaries_dir``, and the console monitor printed every
``--train_monitor_every`` steps with the step rate and the share of time
spent waiting for input.  The port of ``nhans_tpu/train/metrics.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional


class MetricsWriter:
    """JSONL (the record) and a TensorBoard event file, both under
    ``--summaries_dir``.  Safe to call from an evaluation thread beside
    the training loop."""

    def __init__(self, summaries_dir: str, name: str,
                 tensorboard: bool = True):
        os.makedirs(summaries_dir, exist_ok=True)
        self.path = os.path.join(summaries_dir, f"{name}.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        self._lock = threading.Lock()
        if tensorboard:
            from nhans_tpu_torch.utils.tb_events import EventFileWriter
            self._tb = EventFileWriter(summaries_dir, name_suffix=name)

    def write(self, step: int, tag_values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in tag_values.items()})
        with self._lock:
            self._f.write(json.dumps(rec) + "\n")
            if self._tb is not None:
                self._tb.add_scalars(step, tag_values)

    def close(self) -> None:
        with self._lock:
            self._f.close()
            if self._tb is not None:
                self._tb.close()


class Monitor:
    """Aggregates training monitors and prints the reference's monitor
    block every ``every`` steps."""

    def __init__(self, every: int, writer: Optional[MetricsWriter] = None):
        self.every = every
        self.writer = writer
        self.agg: Dict[str, float] = {}
        self.input_wait = 0.0
        self._t0 = time.time()

    def update(self, step: int, values: Dict[str, float],
               input_wait: float = 0.0) -> None:
        for k, v in values.items():
            self.agg[k] = self.agg.get(k, 0.0) + float(v)
        self.input_wait += input_wait
        if step % self.every == 0:
            elapsed = time.time() - self._t0
            print(f"----- TRAIN MONITOR AFTER ANOTHER {self.every} BATCHES "
                  "------------")
            print(f"step number: {step}")
            means = {k: v / self.every for k, v in self.agg.items()}
            for k in sorted(means):
                print(f"{k}: {means[k]}")
            print(f"seconds elapsed: {elapsed}")
            print(f"steps/sec: {self.every / max(elapsed, 1e-9):.2f}  "
                  f"input-wait: {self.input_wait:.2f}s "
                  f"({100 * self.input_wait / max(elapsed, 1e-9):.1f}%)")
            print("---------------------------------------------------------")
            if self.writer:
                means["steps_per_sec"] = self.every / max(elapsed, 1e-9)
                means["input_wait_frac"] = self.input_wait / max(elapsed, 1e-9)
                self.writer.write(step, means)
            self.agg = {}
            self.input_wait = 0.0
            self._t0 = time.time()
