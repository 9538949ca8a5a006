"""The training corpus resident in device memory: the port of
``nhans_tpu/data/banks.py``.

The whole corpus is decoded once into int16 tensors on the device, and
each step sends only int32 index triples; the train step gathers the
rows on the device (``train/step.py``, banked).  ``BankIndexLoader`` is
step-indexed: batch t is a pure function of (seed, t), the same stream
as the JAX package's for the same seed and start step.

Speaker-aware sampling: a file named ``spk<ID>_...`` belongs to speaker
ID.  The separator draws its interfering utterance from another real
voice than the target's when the corpus has two or more.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.data.manifest import load_seeds
from nhans_tpu_torch.parallel.mesh import local_world_size, world_size
from nhans_tpu_torch.utils import native, wavio

_SPK_RE = re.compile(r"^spk([A-Za-z0-9]+)[_.]")


def speaker_of(path: str) -> str:
    """Speaker id of a ``spk<ID>_...`` file name; otherwise the file stem
    (every file its own speaker)."""
    base = os.path.basename(path)
    m = _SPK_RE.match(base)
    return m.group(1) if m else os.path.splitext(base)[0]


def real_speaker_of(path: str) -> str:
    """Speaker id with pseudo-speaker tags ``p<digits>`` stripped to a
    fixpoint (``spks3tp0p09`` -> ``s3t``), as long as an id remains, so
    that a voice is never paired with a perturbed copy of itself."""
    sid = speaker_of(path)
    while True:
        stripped = re.sub(r"(?<=.)p[0-9]+$", "", sid)
        if stripped == sid:
            return sid
        sid = stripped


def build_disjoint_table(paths: List[str]) -> Optional[List[np.ndarray]]:
    """Entry i: indices of the utterances whose real voice differs from
    utterance i's.  ``None``, with a warning, when the corpus has fewer
    than 2 real voices (pairing then unconstrained)."""
    real = [real_speaker_of(p) for p in paths]
    spk = np.asarray(real)
    if len(set(real)) >= 2:
        return [np.flatnonzero(spk != s) for s in real]
    print("WARNING: separator speaker-disjoint sampling DISABLED — "
          f"corpus has {len(set(real))} distinct real voice(s); "
          "target/interferer pairs are unconstrained (same-voice "
          "mixtures possible)", flush=True)
    return None


def corpus_bytes(paths: List[str]) -> int:
    """Approximate decoded int16 bytes (a wav's payload is about its
    file size)."""
    return sum(os.path.getsize(p) for p in paths)


def _decode_all(paths: List[str], max_samples: int, sample_rate: int,
                use_native: bool) -> tuple:
    """Every file in one int16 [N, longest] array, lengths [N] (capped at
    ``max_samples``) and whole-file peaks [N]: on the native decoder's
    threads with ``use_native``, else one file at a time with numpy."""
    if use_native:
        buf, lens, peaks = native.load_batch_i16(list(paths), max_samples,
                                                 sample_rate, num_threads=4)
        return (np.ascontiguousarray(buf[:, :int(lens.max())]),
                lens, peaks)
    rows, lens, peaks = [], [], []
    for p in paths:
        x = np.asarray(wavio.read_wav_strict(p), np.float32)
        peaks.append(float(np.max(np.abs(x))) if len(x) else 0.0)
        x = x[:max_samples]
        lens.append(len(x))
        rows.append(x)
    out = np.zeros((len(rows), max(lens, default=1)), np.int16)
    for i, x in enumerate(rows):
        out[i, :len(x)] = np.rint(x)
    return out, np.asarray(lens, np.int32), np.asarray(peaks, np.float32)


def _pad_frames(a: np.ndarray, frame_length: int, frame_step: int):
    """Pad the sample axis up to whole frames."""
    n = a.shape[1]
    if n < frame_length:
        target = frame_length
    else:
        target = n + (frame_step - (n - frame_length) % frame_step) % frame_step
    return np.pad(a, ((0, 0), (0, target - n))) if target > n else a


class DeviceBanks:
    """The decoded corpus on ``device``.  ``banks`` holds "speech",
    "speech_len", "speech_peak", "noise", "noise_len", "noise_peak"; for
    the separator the noise entries are the speech tensors themselves.
    ``decoder`` says which decoder read the wavs: "native" (the threaded
    binding, ``utils/native.py``) where it builds, else "numpy"."""

    def __init__(self, cfg: Config, device, split: str = "train"):
        self.cfg = cfg
        self.speech_paths = load_seeds(cfg.data.speech_wav_dir, split)
        self.two_noise = cfg.task.two_noise_mixing
        self.noise_paths = (load_seeds(cfg.data.noise_wav_dir, split)
                            if self.two_noise else self.speech_paths)
        if not self.speech_paths or not self.noise_paths:
            raise ValueError("empty manifest(s)")
        L = cfg.data.max_samples
        fl, step = cfg.audio.frame_length, cfg.audio.frame_step

        def place(arrays):
            wav, lens, peaks = arrays
            return (torch.from_numpy(_pad_frames(wav, fl, step)).to(device),
                    torch.from_numpy(lens).to(device),
                    torch.from_numpy(peaks).to(device))

        use_native = native.available()
        self.decoder = "native" if use_native else "numpy"
        fs = cfg.audio.sample_rate
        sp, sp_len, sp_pk = place(_decode_all(self.speech_paths, L, fs,
                                              use_native))
        banks = {"speech": sp, "speech_len": sp_len, "speech_peak": sp_pk}
        if self.two_noise:
            ns, ns_len, ns_pk = place(_decode_all(self.noise_paths, L, fs,
                                                  use_native))
        else:
            ns, ns_len, ns_pk = sp, sp_len, sp_pk
        banks.update(noise=ns, noise_len=ns_len, noise_peak=ns_pk)
        self.banks: Dict[str, torch.Tensor] = banks
        self.nbytes = sum({id(v): v.numel() * v.element_size()
                           for v in banks.values()}.values())
        self.speakers = [speaker_of(p) for p in self.speech_paths]


class BankIndexLoader:
    """Endless step-indexed stream of index batches for ``DeviceBanks``:
    {"clean_idx", "a_idx", "b_idx"}, each int32 [B], from
    ``numpy.random.default_rng((seed, step))``.

    ``shard`` = (data index, data size): the triples are drawn for the
    global batch of ``batch_utts`` and the rank keeps its contiguous block
    of ``batch_utts / size`` rows, so that a banked N-rank run feeds the
    1-rank run's batch."""

    def __init__(self, banks: DeviceBanks, batch_utts: int,
                 seed: Optional[int] = None, start_step: int = 0,
                 shard: Tuple[int, int] = (0, 1)):
        cfg = banks.cfg
        self.B = batch_utts
        index, count = shard
        if batch_utts % count:
            raise ValueError(f"{batch_utts} utterances do not split over "
                             f"{count} data ranks")
        per = batch_utts // count
        self._rows = slice(index * per, (index + 1) * per)
        self.two_noise = banks.two_noise
        self.n_speech = len(banks.speech_paths)
        self.n_noise = len(banks.noise_paths)
        self._seed = cfg.data.seed if seed is None else seed
        self._step = start_step
        self._other: Optional[List[np.ndarray]] = None
        if not self.two_noise:
            self._other = build_disjoint_table(banks.speech_paths)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self._seed, self._step))
        self._step += 1
        B = self.B
        ci = rng.integers(self.n_speech, size=B).astype(np.int32)
        if self.two_noise:
            ai = rng.integers(self.n_noise, size=B).astype(np.int32)
            bi = rng.integers(self.n_noise, size=B).astype(np.int32)
        elif self._other is not None:
            ai = np.asarray([self._other[c][rng.integers(
                len(self._other[c]))] for c in ci], np.int32)
            bi = np.zeros(B, np.int32)
        else:
            ai = rng.integers(self.n_noise, size=B).astype(np.int32)
            bi = np.zeros(B, np.int32)
        r = self._rows
        return {"clean_idx": ci[r], "a_idx": ai[r], "b_idx": bi[r]}

    def close(self) -> None:  # the loader protocol of TrainLoader
        pass


def banks_enabled(cfg: Config, split: str = "train") -> bool:
    """Whether this run keeps its corpus on the device: ``off`` never,
    ``on`` always (an error if the corpus exceeds the budget or the world
    spans nodes), ``auto`` when the decoded corpus fits
    ``device_corpus_mb`` and the world is one node.  Every rank holds the
    whole corpus, which needs the same files on every rank: across nodes
    the streaming loader shards the manifest instead, as the JAX package
    does across hosts."""
    mode = cfg.data.device_corpus
    if mode == "off":
        return False
    multi_node = world_size() > local_world_size()
    try:
        speech = load_seeds(cfg.data.speech_wav_dir, split)
        noise = (load_seeds(cfg.data.noise_wav_dir, split)
                 if cfg.task.two_noise_mixing else [])
        total = corpus_bytes(speech) + corpus_bytes(noise)
    except (FileNotFoundError, OSError):
        if mode == "on":
            raise
        return False
    fits = total <= cfg.data.device_corpus_mb * (1 << 20)
    if mode == "on":
        if multi_node:
            raise ValueError(
                "device_corpus=on is single-host only (replicated banks "
                "require identical content on every host; the streaming "
                "loader shards manifests per host instead)")
        if not fits:
            raise ValueError(
                f"device_corpus=on but corpus is {total >> 20} MB > "
                f"budget {cfg.data.device_corpus_mb} MB")
        return True
    return (not multi_node) and fits
