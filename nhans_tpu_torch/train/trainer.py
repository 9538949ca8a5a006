"""The trainer, the port of ``nhans_tpu/train/trainer.py``.

* The step's random draws come from a generator that is a pure function
  of (seed + 17, step), and the banked index stream is step-indexed, so a
  run resumed from a checkpoint replays an uninterrupted one.
* Auto-resume: when ``checkpoint_dir`` already holds steps, training
  continues from the latest; ``--restore_path`` takes a step directory
  or run root (full state), or a variables directory or a flat ``.npz``
  (variables only: fresh optimizer, step 0), of the port or of the JAX
  package's Orbax (``train/checkpoint.py``; its optax state mapped for
  this run's ``--alg``).
* Loss and gradient norm stay on the device until a monitor boundary.
  Rank 0 records its loop's spans (``utils/spans.py``): ``train.fetch``
  around the batch fetch, whose host time is the input wait
  (``input_wait_frac``), inside ``train.iteration``, which runs from
  before the fetch to after the step's last kernel and on a card is
  timed by the device's clock; the metrics record holds its mean over
  the monitor window as ``step_device_ms``.  The ring of spans is
  drained at each monitor boundary.
* Every ``eval_every`` steps and at the end, a checkpoint is saved (the
  Orbax step directory the JAX trainer writes, ``train/checkpoint.py``,
  so either package resumes it) and its weights are scored on ``EvalLoader(cfg, limit=eval_utts)``
  (``train/evaluate.py``), and the metrics go to the record at that
  step.  The evaluator holds its own copy of the model in inference
  mode, so the training module's mode never changes.  With
  ``async_eval`` the copy is taken on the device at save time, ordered
  after the step that produced it, and scored on a host thread (on a
  CUDA stream of its own on a card) while training goes on; the
  previous evaluation is joined before the next one starts and at
  shutdown.  With ``eval_utts=0`` the record gets the JAX trainer's
  all-zero ``eval_loss``/``si_sdr``/``si_sdr_mixed``/``si_sdr_gain``,
  and no eval manifest is read.
* With ``profile_dir``, a ``torch.profiler`` trace (CPU and, on a card,
  CUDA activities) of steps 10 to 20 is written there as Chrome-trace
  JSON, the spans of the loop and the step among its events by name; a
  run that ends before step 20 writes what it traced.
* Several ranks (``mesh``, ``parallel/``): the global batch of
  ``batch_utts`` utterances is rounded up to a multiple of the data axis
  and each rank feeds its ``local_utts`` (the banked stream's rows of the
  global draw, or the streaming loader on its manifest shard).  Rank 0
  writes the checkpoint (full tensors) while the others wait at a
  barrier, and every rank auto-resumes from it.  Evaluation, wav dumps,
  the metrics record, the profiler trace and the printed lines are rank
  0's; the evaluation thread runs no collective.  ``step_device_ms``
  is rank 0's own step.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.data.banks import (BankIndexLoader, DeviceBanks,
                                        banks_enabled)
from nhans_tpu_torch.data.loader import (EvalLoader, TrainLoader,
                                         prefetch_to_device)
from nhans_tpu_torch.models import build_model
from nhans_tpu_torch.parallel.mesh import (Mesh, barrier, local_batch_size,
                                           make_mesh)
from nhans_tpu_torch.parallel.sharding_rules import (cut_full, gather_full,
                                                     model_shards)
from nhans_tpu_torch.train import checkpoint as ckpt
from nhans_tpu_torch.train.evaluate import Evaluator
from nhans_tpu_torch.train.metrics import MetricsWriter, Monitor
from nhans_tpu_torch.train.step import (TrainState, create_state,
                                        make_train_step, param_counts,
                                        state_of, step_generator)
from nhans_tpu_torch.utils import spans
from nhans_tpu_torch.utils.device import resolve_device
from nhans_tpu_torch.utils.watchdog import Heartbeat


class Trainer:
    """``eval_utts``: utterances a scoring pass takes (None: the whole
    eval split); ``eval_kwargs``: the ``Evaluator``'s own arguments;
    ``mesh``: the ranks' layout (default: ``make_mesh`` of the config's
    ``data_axis`` and ``model_axis`` over the world, one rank without a
    process group)."""

    def __init__(self, cfg: Config, eval_utts: Optional[int] = 16,
                 device="cuda", eval_kwargs: Optional[dict] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        t = cfg.train
        self.device = resolve_device(device)
        self.mesh = mesh or make_mesh(t.data_axis or None, t.model_axis)
        self.primary = self.mesh.is_primary
        self.eval_utts = eval_utts
        init = torch.Generator()
        init.manual_seed(cfg.data.seed)
        self.model, self.state, self.tx = create_state(
            cfg, init, self.device, self.mesh)
        self.shards = model_shards(self.model)
        self.banked = banks_enabled(cfg)
        self.step_fn = make_train_step(cfg, self.model, self.tx,
                                       banked=self.banked, mesh=self.mesh)
        self.ckpt = ckpt.make_checkpointer(t)
        self.evaluator = self.writer = self.monitor = None
        if self.primary:
            self.evaluator = Evaluator(cfg, build_model(cfg).to(self.device),
                                       **(eval_kwargs or {}))
            self.writer = MetricsWriter(t.summaries_dir, t.model_name)
            self.monitor = Monitor(t.train_monitor_every, self.writer)
        self._eval_thread: Optional[threading.Thread] = None
        self._eval_error: Optional[BaseException] = None
        self.tstep = 0
        self.trace_path: Optional[str] = None  # the profiler's trace
        self.decoder: Optional[str] = None  # "native" or "numpy", in train
        # utterances a step: train_mb // slices_per_step, at least 1,
        # rounded up to a multiple of the data axis; each rank feeds its
        # share
        self.local_utts = local_batch_size(
            max(t.train_mb // cfg.data.slices_per_step, 1), self.mesh)
        self.batch_utts = self.local_utts * self.mesh.data

        trainable, non_trainable = param_counts(self._full_state())
        self._say(f"#trainable variables: {trainable}")
        self._say(f"#non-trainable variables: {non_trainable}")
        self._restore()

    def _say(self, msg: str) -> None:
        if self.primary:
            print(msg)

    def _full_state(self) -> TrainState:
        """The state with every model-axis block joined to its full tensor
        (a collective over the model group; the state itself without the
        model axis)."""
        if not self.shards:
            return self.state
        s = self.state
        opt = {k: (v if k == "count" else gather_full(v, self.shards))
               for k, v in s.opt_state.items()}
        return TrainState(step=s.step,
                          params=gather_full(s.params, self.shards),
                          batch_stats=s.batch_stats, opt_state=opt)

    def _restore(self) -> None:
        t = self.cfg.train
        if t.restore_path:
            self._say(f"Restoring model from {t.restore_path}")
            variables, extra = ckpt.load(t.restore_path, alg=t.alg)
            ckpt.load_into(self.model, variables)
            if extra is not None:
                self._load_train_state(extra)
            else:
                # variables only: fine-tune from step 0 with a fresh
                # optimizer
                self.state = state_of(self.model, self.tx)
                self.tstep = 0
                self._say("Restored inference variables only "
                          "(fine-tune: fresh optimizer, step 0)")
        elif self.ckpt.latest_step() is not None:
            step, variables, extra = self.ckpt.restore()
            ckpt.load_into(self.model, variables)
            self._load_train_state(extra)
            self._say(f"Auto-resumed from checkpoint step {step}")

    def _load_train_state(self, extra: dict) -> None:
        alg = str(extra["alg"])
        if alg != self.cfg.train.alg.lower():
            raise ValueError(f"checkpoint was trained with --alg {alg}, "
                             f"this run asks for {self.cfg.train.alg}")
        opt = ckpt.opt_state_from_flat(extra, self.device)
        if set(opt) != set(self.state.opt_state):
            raise ValueError(
                f"the checkpoint's optimizer slots {sorted(opt)} do not fit "
                f"--alg {self.cfg.train.alg} (mom {self.cfg.train.mom}), "
                f"whose slots are {sorted(self.state.opt_state)}")
        # contiguous once here: the update kernel takes no other layout
        self.state.opt_state = {
            k: (v if k == "count" else
                {n: t.contiguous()
                 for n, t in cut_full(v, self.shards).items()})
            for k, v in opt.items()}
        self.state.step = self.tstep = int(extra["step"])

    def _beat(self, phase: str) -> None:
        hb = getattr(self, "_heartbeat", None)
        if hb is not None:
            hb.beat(phase)

    def save_and_eval(self, async_eval: bool = False) -> None:
        """Every rank calls it: rank 0 saves and scores, the others wait
        for the checkpoint at a barrier."""
        self._say("Saving the model")
        self._beat(f"save(step {self.tstep})")
        full = self._full_state()
        if self.primary:
            path = self.ckpt.save(self.tstep, full)
            print(f"checkpoint written: {path}")
        barrier()
        if not self.primary:
            return
        step = self.tstep
        # the previous evaluation reads the evaluator's weights to its end
        self._join_eval()
        if self.eval_utts == 0:
            self._eval(step, loader=[])
            return
        self._beat(f"eval(step {step})")
        # the snapshot: copies queued on this stream after the step
        self.evaluator.model.load_state_dict({**full.params,
                                              **full.batch_stats})
        if not async_eval:
            self._eval(step)
            return
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._eval_thread = threading.Thread(
            target=self._eval_async, args=(step, ready), daemon=True,
            name=f"eval-step-{step}")
        self._eval_thread.start()

    def _eval(self, step: int, loader=None) -> None:
        """Score the evaluator's weights and write the metrics at
        ``step``."""
        t = self.cfg.train
        print("----------------- TEST MONITOR ----------------------")
        if loader is None:
            loader = EvalLoader(self.cfg, limit=self.eval_utts)
        metrics = self.evaluator.run(
            None, loader, step=step, modelname=t.model_name,
            wav_dump_folder=t.wav_dump_folder or None,
            dump_results=t.dump_results or None,
            max_utts=self.eval_utts, return_metrics=True)
        self.writer.write(step, metrics)
        print("-----------------------------------------------------")

    def _eval_async(self, step: int, ready) -> None:
        """The thread's body: on a card, a stream of its own that first
        waits for the snapshot's copies.  A failure is raised by the
        next join."""
        try:
            if ready is None:
                self._eval(step)
                return
            stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                stream.wait_event(ready)
                self._eval(step)
            stream.synchronize()
        except BaseException as err:  # raised again in _join_eval
            self._eval_error = err

    def _join_eval(self) -> None:
        if self._eval_thread is not None:
            self._eval_thread.join()
            self._eval_thread = None
        if self._eval_error is not None:
            err, self._eval_error = self._eval_error, None
            raise RuntimeError("asynchronous evaluation failed") from err

    def train(self) -> None:
        cfg, t = self.cfg, self.cfg.train
        banks = None
        shard = (self.mesh.data_index, self.mesh.data)
        if self.banked:
            dbanks = DeviceBanks(cfg, self.device)
            banks = dbanks.banks
            self._say(f"device corpus banks: {len(dbanks.speech_paths)} "
                      f"speech + {len(dbanks.noise_paths)} noise files, "
                      f"{dbanks.nbytes >> 20} MB on {self.device}")
            loader = BankIndexLoader(dbanks, self.batch_utts,
                                     start_step=self.tstep, shard=shard)
            self.decoder = dbanks.decoder
        else:
            # the model ranks of a data index must see the same rows: one
            # worker thread makes the stream's order its seed's
            workers = 1 if self.mesh.model > 1 else None
            loader = TrainLoader(cfg, self.local_utts, shard=shard,
                                 num_workers=workers)
            self.decoder = loader.decoder
        self._say(f"wav decoder: {self.decoder}")
        stream = prefetch_to_device(loader, self.device)

        if t.eval_before_training:
            self.save_and_eval()

        # (metrics, step number) of each step, read with the step's spans
        # at monitor boundaries
        pending = []
        profiler = None
        self._heartbeat = Heartbeat(name="trainer").start()
        try:
            with (spans.recording() if self.primary
                  else contextlib.nullcontext()):
                while self.tstep < t.batches:
                    if (t.profile_dir and self.primary and self.tstep == 10
                            and profiler is None):
                        profiler = self._start_profiler()
                    if profiler is not None and self.tstep >= 20:
                        self._stop_profiler(profiler)
                        profiler = None
                    self._beat(f"train step {self.tstep}")
                    step = self.tstep
                    with spans.span("train.iteration", id=step,
                                    device=self.device):
                        with spans.span("train.fetch", id=step):
                            batch = next(stream)
                        gen = step_generator(cfg.data.seed + 17, step)
                        if self.banked:
                            metrics = self.step_fn(self.state, banks, batch,
                                                   gen)
                        else:
                            metrics = self.step_fn(self.state, batch, gen)
                    self.tstep += 1
                    pending.append((metrics, step))
                    if self.tstep % t.train_monitor_every == 0:
                        if self.primary:
                            self._monitor(pending)
                        pending = []
                    if self.tstep % t.eval_every == 0:
                        self.save_and_eval(async_eval=t.async_eval)
            if profiler is not None:  # the run ended before step 20
                self._stop_profiler(profiler)
                profiler = None
            if t.eval_after_training:
                self.save_and_eval()
        finally:
            self._beat("shutdown: join the evaluation thread")
            try:
                if profiler is not None:
                    self._stop_profiler(profiler)
                self._join_eval()
            finally:
                stream.close()
                loader.close()
                if self.writer is not None:
                    self.writer.close()
                self._heartbeat.stop()

    def _monitor(self, pending) -> None:
        """The monitor window's steps to the monitor: loss and gradient
        norm, the input wait (``train.fetch``'s host time) and, on a card,
        ``step_device_ms`` (``train.iteration``'s device time), from the
        spans drained from the ring."""
        found = {(s.name, s.id): s for s in spans.drain()
                 if s.name in ("train.iteration", "train.fetch")}
        for m, step in pending:
            values = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])}
            whole = found.get(("train.iteration", step))
            if whole is not None and whole.device_ms is not None:
                values["step_device_ms"] = whole.device_ms
            fetch = found.get(("train.fetch", step))
            self.monitor.update(step + 1, values,
                                fetch.host_ms / 1e3 if fetch else 0.0)

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Stop ``profiler`` once the card has finished the traced steps
        and write its Chrome trace under ``profile_dir``."""
        d = self.cfg.train.profile_dir
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(d, exist_ok=True)
        self.trace_path = os.path.join(d, f"{self.cfg.train.model_name}_"
                                          f"steps_10_{self.tstep}.json")
        profiler.export_chrome_trace(self.trace_path)
        print(f"profiler trace written to {d}")
