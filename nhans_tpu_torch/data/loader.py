"""The loaders: the streaming training loader (worker threads that only
decode wavs into fixed-shape int16 buffers), the deterministic
evaluation loader, and a prefetch thread that moves batches to the
device.  The port of ``nhans_tpu/data/loader.py::TrainLoader``,
``EvalLoader`` and ``prefetch_to_device``, for one process.  The training
loader decodes on the threads of the native binding (``utils/native.py``)
where it builds, as the JAX package does, else with ``utils/wavio.py``;
the evaluation loader with ``utils/wavio.py``.

Mixing, spectrograms and crops happen on the device
(``data/pipeline.py``).  A worker's exception is raised in the consumer,
not swallowed.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.data.banks import build_disjoint_table
from nhans_tpu_torch.data.manifest import load_seeds
from nhans_tpu_torch.dsp.mixing import snr_index_from_path
from nhans_tpu_torch.parallel.mesh import process_shard
from nhans_tpu_torch.utils import native, wavio


def _decode(path: str, max_samples: int) -> tuple:
    """(samples capped at max_samples, n, whole-file peak): the peak is
    that of the whole file, so that normalisation on the device matches
    the reference's even when the buffer cuts a long file."""
    x = np.asarray(wavio.read_wav_strict(path), np.float32)
    peak = float(np.max(np.abs(x))) if len(x) else 0.0
    n = min(len(x), max_samples)
    return x[:n], n, peak


def bucket_length(cfg: Config, longest: int) -> int:
    """The smallest length bucket (samples) that holds ``longest``,
    ``max_samples`` at most."""
    L, fs = cfg.data.max_samples, cfg.audio.sample_rate
    for sec in sorted(cfg.data.length_buckets):
        bs = min(int(sec * fs), L)
        if bs >= longest:
            return bs
    return L


class TrainLoader:
    """Endless shuffled stream of raw-waveform batches.

    Yields dicts: clean/noise_a/noise_b [B, bucket] int16 (or float32
    with ``transfer_dtype="float32"``), un-normalised, the valid lengths
    and the whole-file peaks [B, 3].  For the separator ``noise_a`` is
    another speech utterance, from another real voice where the corpus
    has two or more, and ``noise_b`` is zeros.  ``decoder``: "native" or
    "numpy", the decoder the workers use.

    ``shard`` = (data index, data size): the rank reads
    ``process_shard(manifest)`` at its data index, as the JAX package's
    hosts do.  The separator's interferers come from the whole manifest
    through the other-speaker table, so that a shard holding one voice
    keeps the speaker-disjoint pairing."""

    def __init__(self, cfg: Config, batch_utts: int, split: str = "train",
                 seed: Optional[int] = None,
                 num_workers: Optional[int] = None,
                 shard: Tuple[int, int] = (0, 1)):
        self.cfg = cfg
        self.batch = batch_utts
        self.L = cfg.data.max_samples
        self.two_noise = cfg.task.two_noise_mixing
        speech_full = load_seeds(cfg.data.speech_wav_dir, split)
        self.speech = process_shard(speech_full, *shard)
        self.noise = (process_shard(load_seeds(cfg.data.noise_wav_dir,
                                               split), *shard)
                      if self.two_noise else self.speech)
        if not self.speech or not self.noise:
            raise ValueError("empty manifest(s)")
        self._other: Optional[List[np.ndarray]] = None
        self._speech_full = speech_full
        self._shard_to_full: Optional[List[int]] = None
        if not self.two_noise:
            self._other = build_disjoint_table(speech_full)
            full_idx = {p: k for k, p in enumerate(speech_full)}
            self._shard_to_full = [full_idx[p] for p in self.speech]
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.data.prefetch * 2)
        self._err: List[BaseException] = []
        self._stop = threading.Event()
        # decoded-file cache: path -> (samples[:n] in the wire type, n, peak)
        self._cache: Dict[str, tuple] = {}
        self._cache_bytes = 0
        self._cache_budget = cfg.data.decode_cache_mb * (1 << 20)
        self._cache_lock = threading.Lock()
        self.decoder = "native" if native.available() else "numpy"
        base_seed = cfg.data.seed if seed is None else seed
        self._threads = []
        for w in range(num_workers or cfg.data.num_workers):
            t = threading.Thread(target=self._worker,
                                 args=(base_seed * 1000 + w,), daemon=True)
            t.start()
            self._threads.append(t)

    def _paths(self, rng) -> tuple:
        B = self.batch
        cidx = [int(rng.integers(len(self.speech))) for _ in range(B)]
        cpaths = [self.speech[i] for i in cidx]
        if self._other is not None:
            # table rows and entries are positions in the whole manifest
            others = [self._other[self._shard_to_full[i]] for i in cidx]
            apaths = [self._speech_full[o[rng.integers(len(o))]]
                      for o in others]
        else:
            apaths = [self.noise[rng.integers(len(self.noise))]
                      for _ in range(B)]
        bpaths = ([self.noise[rng.integers(len(self.noise))]
                   for _ in range(B)] if self.two_noise else [])
        return cpaths, apaths, bpaths

    def _records(self, paths, wire) -> Dict[str, tuple]:
        """Decoded records of ``paths``, from the cache where they are."""
        local = {}
        missing = sorted({p for p in paths if p not in self._cache})
        if missing and self.decoder == "native":
            load = (native.load_batch_i16 if wire == np.int16
                    else native.load_batch)
            buf, lens, pks = load(missing, self.L,
                                  self.cfg.audio.sample_rate, num_threads=2)
            for j, p in enumerate(missing):
                n = int(lens[j])
                local[p] = (buf[j, :n].copy(), n, float(pks[j]))
        else:
            for p in missing:
                x, n, pk = _decode(p, self.L)
                if wire == np.int16:
                    x = np.rint(x).astype(np.int16)
                local[p] = (np.ascontiguousarray(x[:n]), n, pk)
        if self._cache_budget and local:
            with self._cache_lock:
                for p, rec in local.items():
                    sz = rec[0].nbytes
                    if (p not in self._cache and
                            self._cache_bytes + sz <= self._cache_budget):
                        self._cache[p] = rec
                        self._cache_bytes += sz
        return {p: self._cache.get(p) or local[p] for p in paths}

    def _batch(self, rng) -> Dict[str, np.ndarray]:
        B = self.batch
        wire = (np.int16 if self.cfg.data.transfer_dtype == "int16"
                else np.float32)
        cpaths, apaths, bpaths = self._paths(rng)
        rec = self._records(cpaths + apaths + bpaths, wire)
        # all three buffers ride the clean batch's length bucket: noise
        # past the clean length is never used
        bucket = bucket_length(self.cfg, max(rec[p][1] for p in cpaths))
        out = {k: np.zeros((B, bucket), wire)
               for k in ("clean", "noise_a", "noise_b")}
        lens = {k: np.zeros((B,), np.int32)
                for k in ("clean_len", "len_a", "len_b")}
        peaks = np.zeros((B, 3), np.float32)
        for col, (buf, ln, plist) in enumerate(
                (("clean", "clean_len", cpaths), ("noise_a", "len_a", apaths),
                 ("noise_b", "len_b", bpaths))):
            for b, p in enumerate(plist):
                x, n, pk = rec[p]
                n = min(n, bucket)
                out[buf][b, :n] = x[:n]
                lens[ln][b] = n
                peaks[b, col] = pk
        return {**out, **lens, "peaks": peaks}

    def _worker(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        try:
            while not self._stop.is_set():
                batch = self._batch(rng)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced in __next__
            self._err.append(e)
            self._stop.set()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            if self._err:
                raise RuntimeError("data worker failed") from self._err[0]
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                continue

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)


class EvalLoader:
    """Deterministic one-epoch stream of evaluation utterances, the port
    of ``nhans_tpu/data/loader.py::EvalLoader``.

    Speech files in manifest order.  Pairing ``wrap`` (every utterance
    scored): the denoiser takes noises 2i and 2i + 1 of the noise
    manifest, cycled; the separator takes the next speech utterance as
    its interferer.  Pairing ``queue`` (the reference's one-epoch queue
    order): the same noises, ending where the noise manifest runs out;
    the separator pairs speech 2j with speech 2j + 1.  SNRs come from
    the md5 of the clean path (8 hex digits for the positive noise, 6
    for the negative).  Files decode on a thread pool; examples come out
    in plan order.

    Yields dicts: clean/noise_a/noise_b float32 samples (int16 scale,
    capped at ``max_samples``), their lengths, the whole-file peaks [3],
    the SNRs and the three paths (``path_b`` "" for the separator).
    """

    def __init__(self, cfg: Config, split: Optional[str] = None,
                 limit: Optional[int] = None,
                 num_workers: Optional[int] = None):
        self.cfg = cfg
        split = split or cfg.data.eval_seeds
        self.speech = load_seeds(cfg.data.speech_wav_dir, split)
        self.two_noise = cfg.task.two_noise_mixing
        self.noise = (load_seeds(cfg.data.noise_wav_dir, split)
                      if self.two_noise else self.speech)
        if limit:
            self.speech = self.speech[:limit]
        self.L = cfg.data.max_samples
        self.num_workers = (num_workers if num_workers is not None
                            else min(cfg.data.num_workers, 8))

    def _plan(self):
        snrs = self.cfg.task.snr_set
        queue_order = self.cfg.data.eval_pairing == "queue"
        for i, cpath in enumerate(self.speech):
            if self.two_noise:
                if queue_order and 2 * i + 1 >= len(self.noise):
                    return  # the one-epoch noise queue ran out
                apath = self.noise[(2 * i) % len(self.noise)]
                bpath = self.noise[(2 * i + 1) % len(self.noise)]
                snr_a = snrs[snr_index_from_path(cpath, len(snrs), 8)]
                snr_b = snrs[snr_index_from_path(cpath, len(snrs), 6)]
            else:
                if queue_order:
                    # two dequeues of the one speech queue per example
                    if 2 * i + 1 >= len(self.speech):
                        return
                    cpath = self.speech[2 * i]
                    apath = self.speech[2 * i + 1]
                else:
                    apath = self.speech[(i + 1) % len(self.speech)]
                bpath = None
                snr_a = snrs[snr_index_from_path(cpath, len(snrs), 8)]
                snr_b = 0
            yield cpath, apath, bpath, snr_a, snr_b

    def _load(self, item) -> Dict:
        cpath, apath, bpath, snr_a, snr_b = item
        clean, n_c, pk_c = _decode(cpath, self.L)
        na, n_a, pk_a = _decode(apath, self.L)
        nb, n_b, pk_b = (_decode(bpath, self.L) if bpath
                         else (np.zeros(1, np.float32), 0, 0.0))
        return {
            "clean": clean, "noise_a": na, "noise_b": nb,
            "clean_len": n_c, "len_a": n_a, "len_b": n_b,
            "peaks": np.asarray([pk_c, pk_a, pk_b], np.float32),
            "snr_a": snr_a, "snr_b": snr_b,
            "cleanpath": cpath, "path_a": apath, "path_b": bpath or "",
        }

    def __iter__(self):
        if self.num_workers <= 1:
            for item in self._plan():
                yield self._load(item)
            return
        # a sliding window of decodes in flight, read in plan order
        depth = self.num_workers * 2
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            for item in self._plan():
                pending.append(pool.submit(self._load, item))
                if len(pending) >= depth:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()


def prefetch_to_device(iterator, device, depth: int = 2):
    """Move the iterator's batches (dicts of numpy arrays) to ``device``
    on a background thread, ``depth`` batches ahead of the consumer.  On a
    card the host arrays are pinned and copied without blocking the
    thread."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: List[BaseException] = []

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        if pin:
            torch.cuda.current_stream(device).synchronize()
        return out

    def pump():
        try:
            for batch in iterator:
                placed = put(batch)
                while not stop.is_set():
                    try:
                        q.put(placed, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(None)
        except BaseException as e:
            err.append(e)
            try:
                q.put(None, timeout=0.1)
            except queue.Full:
                pass

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if err:
                    raise RuntimeError("prefetch failed") from err[0]
                return
            yield item
    finally:
        stop.set()
