"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a``; each ``csrc/<name>.cpp`` (host code) with the
host C++ compiler.  The library goes to
``build/nhans_tpu_torch/lib<name>-<hash>.so`` under the repository root
at first use.  The hash is that of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  A build
writes a temporary file and renames it into place, so processes that
build at once leave one whole library.  No PyTorch header is compiled: a
build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "nhans_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

# name -> (ctypes.CDLL, build record); one load per process
_LOADED: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of nhans_tpu_torch are built on the machine with "
                       "the card")


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (set CXX)")


def load(name: str):
    """(ctypes.CDLL, record) for the CUDA source ``csrc/<name>.cu``,
    building it if its library is missing.  ``record`` holds the library
    path, the build seconds (0.0 when an earlier build was reused) and
    nvcc's ptxas lines (registers, shared memory, spills)."""
    return _load(name, f"{name}.cu", _nvcc, NVCC_FLAGS)


def load_host(name: str):
    """(ctypes.CDLL, record) for the host C++ source ``csrc/<name>.cpp``,
    built with ``g++ -O3 -std=c++17 -fPIC -pthread -shared``."""
    return _load(name, f"{name}.cpp", _cxx, CXX_FLAGS)


def _load(name: str, source: str, compiler, flags):
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        src = os.path.join(CSRC, source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(flags).encode())
        lib_path = os.path.join(BUILD_DIR,
                                f"lib{name}-{digest.hexdigest()[:16]}.so")
        record = {"path": lib_path, "seconds": 0.0, "ptxas": []}
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([compiler(), *flags, "-o", tmp, src],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"build of {src} failed:\n"
                                       f"{proc.stderr}")
                os.replace(tmp, lib_path)  # atomic: a reader never sees half
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            record["seconds"] = time.perf_counter() - t0
            record["ptxas"] = [
                ln for ln in (proc.stdout + proc.stderr).splitlines()
                if "ptxas" in ln or "spill" in ln]
        _LOADED[name] = (ctypes.CDLL(lib_path), record)
        return _LOADED[name]
