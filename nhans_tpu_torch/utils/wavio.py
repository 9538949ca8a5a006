"""Wav IO with the reference toolkit's input contract plus format
conversion (the port's own copy of ``nhans_tpu/utils/wavio.py``).

* ``read_wav_strict``: 16 kHz / int16 / mono-or-downmixed — exact parity
  with the reference's ``read_wav`` (reference reader.py:118-125).
* ``read_wav_any``: accepts any rate/width/channels and converts to the
  contract (README.md:59-66 documents sox-based auto-conversion living in
  the PyPI-only load_model.py; we implement it natively with a polyphase
  resampler so no external sox binary is needed).
* ``write_wav``: float32 wavs, matching the reference's scipy wavwrite of
  float arrays (reference apply.py:202, main.py:349-353).
"""

from __future__ import annotations

import os
import numpy as np
from scipy.io import wavfile


def read_wav_strict(path: str, fs: int = 16000) -> np.ndarray:
    """Reference read_wav parity: 16 kHz int16 only, stereo downmixed by
    mean (reference reader.py:118-125).  Returns int16-valued float array
    when downmixing, int16 otherwise — same as the reference.  Raises
    ValueError on another rate or sample type."""
    rate, samples = wavfile.read(path)
    if rate != fs:
        raise ValueError(f"{path}: expected {fs} Hz, got {rate}")
    if samples.dtype != np.int16:
        raise ValueError(f"{path}: expected int16, got {samples.dtype}")
    if samples.ndim > 1:
        samples = samples.mean(axis=1)
    return samples


def read_wav_any(path: str, fs: int = 16000) -> np.ndarray:
    """Read any PCM/float wav; scale to [-1, 1] by its sample type, then
    downmix, resample and requantize to the 16 kHz int16 mono contract.
    Returns int16 samples."""
    rate, samples = wavfile.read(path)
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        x = samples.astype(np.float32) / 32768.0
    elif samples.dtype == np.int32:
        x = samples.astype(np.float32) / 2147483648.0
    elif samples.dtype == np.uint8:
        x = (samples.astype(np.float32) - 128.0) / 128.0
    else:  # float32 / float64
        x = samples.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if rate != fs:
        g = np.gcd(int(rate), int(fs))
        # imported here: scipy.signal takes seconds to import, and only
        # a file at another rate needs it
        from scipy.signal import resample_poly
        x = resample_poly(x, fs // g, rate // g).astype(np.float32)
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)


def read_for_processing(path: str, fs: int = 16000,
                        strict: bool = False) -> np.ndarray:
    """Read a wav for the enhancement pipeline as float (un-normalized,
    int16 scale), converting format unless ``strict``."""
    if strict:
        return np.asarray(read_wav_strict(path, fs), np.float64)
    try:
        return np.asarray(read_wav_strict(path, fs), np.float64)
    except ValueError:
        return np.asarray(read_wav_any(path, fs), np.float64)


def write_wav(path: str, samples: np.ndarray, fs: int = 16000) -> None:
    """Write float32 wav (reference parity: scipy wavwrite of float32,
    reference apply.py:202)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    wavfile.write(path, fs, np.asarray(samples, np.float32))


def write_wav_int16(path: str, samples: np.ndarray, fs: int = 16000) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    x = np.clip(np.round(np.asarray(samples, np.float64) * 32767.0),
                -32768, 32767).astype(np.int16)
    wavfile.write(path, fs, x)


def list_wavs(directory: str) -> list:
    out = []
    for root, _, files in os.walk(directory):
        for f in sorted(files):
            if f.lower().endswith(".wav"):
                out.append(os.path.join(root, f))
    return out
