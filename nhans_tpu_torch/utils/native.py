"""ctypes binding of the threaded wav decoder ``csrc/nhans_native.cpp``:
the port of ``nhans_tpu/utils/native.py``, with the same functions.

The library is built at first use with the host C++ compiler into
``build/nhans_tpu_torch/`` (``ops/_build.py::load_host``).  Where it
cannot be built, ``available()`` is False and callers decode with
``utils/wavio.py`` instead, which gives the same samples.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from nhans_tpu_torch.ops import _build

_F32 = ctypes.POINTER(ctypes.c_float)
_I16 = ctypes.POINTER(ctypes.c_int16)
_I64 = ctypes.POINTER(ctypes.c_int64)

# None: not tried yet; False: the build or load failed
_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None:
        try:
            lib, _ = _build.load_host("nhans_native")
        except (RuntimeError, OSError) as err:
            print(f"native wav decoder unavailable ({err}); decoding with "
                  "numpy", flush=True)
            _lib = False
            return None
        lib.nhans_read_wav.restype = ctypes.c_int64
        lib.nhans_read_wav.argtypes = [ctypes.c_char_p, _F32, ctypes.c_int64,
                                       ctypes.c_int32, _F32]
        for fn, buf in ((lib.nhans_load_batch, _F32),
                        (lib.nhans_load_batch_i16, _I16)):
            fn.restype = ctypes.c_int32
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                           buf, ctypes.c_int64, _I64, ctypes.c_int32,
                           ctypes.c_int32, _F32]
        _lib = lib
    return _lib if _lib is not False else None


def available() -> bool:
    """Whether the library is built and loaded (it is built on the first
    call)."""
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native wav decoder unavailable")
    return lib


def read_wav(path: str, max_samples: int,
             expect_rate: int = 16000) -> Tuple[np.ndarray, int, float]:
    """One wav as float32 [max_samples] (int16 scale, zero past the end),
    its length and the whole file's peak (scanned past the cap).  Raises
    ``ValueError`` on a file the strict reader would refuse."""
    lib = _lib_or_raise()
    out = np.zeros(int(max_samples), np.float32)
    peak = ctypes.c_float(0.0)
    n = lib.nhans_read_wav(os.fsencode(path), out.ctypes.data_as(_F32),
                           int(max_samples), int(expect_rate),
                           ctypes.byref(peak))
    if n < 0:
        raise ValueError(f"{path}: native wav decode error {n}")
    return out, int(n), float(peak.value)


def _batch(fn, dtype, paths: List[str], max_samples: int, expect_rate: int,
           num_threads: int):
    n = len(paths)
    out = np.zeros((n, int(max_samples)), dtype)
    lens = np.zeros(n, np.int64)
    peaks = np.zeros(n, np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failed = fn(arr, n, out.ctypes.data_as(_I16 if dtype == np.int16
                                           else _F32),
                int(max_samples), lens.ctypes.data_as(_I64),
                int(expect_rate), int(num_threads), peaks.ctypes.data_as(_F32))
    if failed:
        bad = [paths[i] for i in range(n) if lens[i] < 0]
        raise ValueError(f"native batch decode: {failed} failures: {bad[:3]}")
    return out, lens.astype(np.int32), peaks


def load_batch(paths: List[str], max_samples: int, expect_rate: int = 16000,
               num_threads: int = 8
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A batch of wavs decoded on ``num_threads`` native threads into a
    zeroed float32 [n, max_samples] buffer, with lengths [n] and
    whole-file peaks [n]."""
    return _batch(_lib_or_raise().nhans_load_batch, np.float32, paths,
                  max_samples, expect_rate, num_threads)


def load_batch_i16(paths: List[str], max_samples: int,
                   expect_rate: int = 16000, num_threads: int = 8
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """As ``load_batch``, straight into an int16 buffer (the wire type of
    the training pipeline): multi-channel files are mean-downmixed and
    rounded half away from zero."""
    return _batch(_lib_or_raise().nhans_load_batch_i16, np.int16, paths,
                  max_samples, expect_rate, num_threads)
