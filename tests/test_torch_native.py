"""The port's native wav decoder (``nhans_tpu_torch/utils/native.py``, its
own copy of the C++ source in ``nhans_tpu_torch/csrc/``) against the JAX
package's binding on the same files: equal samples, lengths and peaks
(the covers of tests/test_native.py), the corpus banks and the streaming
loader equal with and without it, and processes that build it at once
leaving one whole library.  Both bindings run the same C++ code, so the
bar is equality; the numpy path matches them exactly on mono files."""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from nhans_tpu.utils import native as jnative
from nhans_tpu_torch.data import banks as banks_mod
from nhans_tpu_torch.data import loader as loader_mod
from nhans_tpu_torch.data.banks import DeviceBanks
from nhans_tpu_torch.data.loader import TrainLoader
from nhans_tpu_torch.ops import _build
from nhans_tpu_torch.utils import native
from tests.test_torch_trainer import _cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    assert native.available(), "the port's decoder did not build"
    if not jnative.ensure_built():
        pytest.skip("the JAX package's native toolchain is unavailable")
    return True


def _write(tmp_path, name, data, fs=16000):
    p = str(tmp_path / name)
    wavfile.write(p, fs, data)
    return p


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("shape,cap", [((12345,), 20000), ((4000, 2), 20000),
                                       ((9000,), 4000), ((9000, 2), 4000)])
def test_read_wav_equals_jax(tmp_path, built, rng, shape, cap):
    x = (rng.standard_normal(shape) * 3000).astype(np.int16)
    p = _write(tmp_path, "a.wav", x)
    got = native.read_wav(p, cap)
    _equal(got, jnative.read_wav(p, cap))
    if x.ndim == 1:
        n = min(len(x), cap)
        np.testing.assert_array_equal(got[0][:n], x[:n].astype(np.float32))
        assert got[2] == float(np.abs(x).max())  # the whole file's peak


@pytest.mark.parametrize("fn", ["load_batch", "load_batch_i16"])
def test_batches_equal_jax(tmp_path, built, rng, fn):
    paths = []
    for i in range(5):
        shape = (3000 + 100 * i,) + ((2,) if i == 3 else ())
        paths.append(_write(tmp_path, f"b{i}.wav",
                            (rng.standard_normal(shape) * 2000
                             ).astype(np.int16)))
    got = getattr(native, fn)(paths, 3300, num_threads=3)
    _equal(got, getattr(jnative, fn)(paths, 3300, num_threads=3))
    assert list(got[1]) == [3000, 3100, 3200, 3300, 3300]


def test_errors_are_raised_as_jax_does(tmp_path, built, rng):
    p = _write(tmp_path, "r.wav", (rng.standard_normal(1000) * 100
                                   ).astype(np.int16), fs=8000)
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.read_wav(p, 4000)
        with pytest.raises(ValueError):
            mod.load_batch([str(tmp_path / "missing.wav")], 100)
        with pytest.raises(ValueError):
            mod.load_batch_i16([p], 100)


def _numpy_only(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def test_banks_equal_with_and_without_the_binding(tmp_path, built,
                                                  monkeypatch):
    cfg = _cfg(tmp_path)
    fast = DeviceBanks(cfg, "cpu")
    assert fast.decoder == "native"
    _numpy_only(monkeypatch)
    slow = DeviceBanks(cfg, "cpu")
    assert slow.decoder == "numpy"
    assert set(fast.banks) == set(slow.banks)
    for k in fast.banks:
        assert fast.banks[k].dtype == slow.banks[k].dtype, k
        assert fast.banks[k].equal(slow.banks[k]), k


@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_loader_equal_with_and_without_the_binding(tmp_path, built,
                                                   monkeypatch, wire):
    import dataclasses

    cfg = _cfg(tmp_path)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               transfer_dtype=wire))
    batches = {}
    for decoder in ("native", "numpy"):
        if decoder == "numpy":
            _numpy_only(monkeypatch)
        loader = TrainLoader(cfg, 3, num_workers=1)
        try:
            assert loader.decoder == decoder
            batches[decoder] = [next(loader) for _ in range(3)]
        finally:
            loader.close()
    for a, b in zip(batches["native"], batches["numpy"]):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert banks_mod.native is loader_mod.native is native


_BUILD = """
import sys
from nhans_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
from nhans_tpu_torch.utils import native
assert native.available()
buf, lens, peaks = native.load_batch_i16([sys.argv[2]], 100)
print(int(lens[0]), int(buf[0, :lens[0]].astype(int).sum()))
"""


def test_parallel_builds_leave_one_library(tmp_path, rng):
    x = (rng.standard_normal(64) * 1000).astype(np.int16)
    wav = _write(tmp_path, "x.wav", x)
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, build_dir, wav],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["64", str(int(x.astype(int).sum()))]
    files = os.listdir(build_dir)
    assert len(files) == 1 and files[0].startswith("libnhans_native-")
    assert files[0].endswith(".so")
    # the port's library is built from its own source into build/, never
    # into the JAX package's native/
    assert os.path.dirname(_build.CSRC).endswith("nhans_tpu_torch")
