"""The port's checkpoint tools: ``tools/ckpt_average`` (the float64 mean
of several step directories, as the JAX tool's ``average_variables``)
and ``tools/ckpt_npz`` (float16 ``params`` and float32 ``batch_stats``,
the format of docs/quality/*_q5_swa.npz, and back).  Both write the
Orbax variables directory the JAX tools write; the steps they read are
Orbax steps as the trainers write them."""

import os
import subprocess
import sys

import numpy as np
import pytest

from nhans_tpu_torch.compat.weights import flat_variables
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.models import random_init_state
from nhans_tpu_torch.tools import ckpt_average, ckpt_npz
from nhans_tpu_torch.compat import orbax
from nhans_tpu_torch.train.checkpoint import load
from tests.make_torch_golden import DENOISER_NPZ

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from ckpt_average import average_variables as j_average  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _variables(seed):
    rng = np.random.default_rng(seed)
    return {"params/block/conv/w": rng.standard_normal((3, 3, 2, 4))
            .astype(np.float32),
            "params/block/conv/b": rng.standard_normal(4).astype(np.float32),
            "batch_stats/block/bn/pop_mean": rng.standard_normal(4)
            .astype(np.float32) * 1e3,
            "batch_stats/block/bn/pop_variance": np.abs(
                rng.standard_normal(4)).astype(np.float32) + 1e-6}


def _steps(root, flats):
    """Orbax step directories ``<root>/<step>`` holding the step and
    ``flats[step]``."""
    for step, flat in flats.items():
        d = os.path.join(root, str(step))
        orbax.write(os.path.join(d, "default"),
                    {"step": np.int32(step), **flat})
        orbax.write_checkpoint_metadata(d, step=True, init_ns=0)


def _variables_dir(path):
    """The arrays of an Orbax variables directory, their dtypes kept."""
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA",
                                        "d", "manifest.ocdbt"]
    return orbax.read(path)


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def test_average_is_the_float64_mean_as_the_jax_tool(tmp_path):
    flats = {s: _variables(s) for s in (100, 200, 300)}
    flats[100]["params/count"] = np.int32(7)
    flats[200]["params/count"] = np.int32(9)
    flats[300]["params/count"] = np.int32(11)
    _steps(str(tmp_path / "run"), flats)
    out = ckpt_average.main(["--checkpoint_root", str(tmp_path / "run"),
                             "--steps", "100,300", "--out",
                             str(tmp_path / "avg")])
    got = _variables_dir(out)
    jax_avg = j_average([_unflatten(flats[100]), _unflatten(flats[300])])
    for key, a in flats[100].items():
        if key == "params/count":
            # integers pass through from the first
            assert got[key] == 7 and got[key].dtype == np.int32
            continue
        want = (a.astype(np.float64) + flats[300][key]) / 2
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want, rtol=1e-7)
        node = jax_avg
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(got[key], np.asarray(node))


def test_average_refuses_checkpoints_of_different_models(tmp_path):
    a, b = _variables(1), _variables(2)
    del b["params/block/conv/b"]
    _steps(str(tmp_path / "run"), {1: a, 2: b})
    with pytest.raises(SystemExit):
        ckpt_average.main(["--checkpoint_root", str(tmp_path / "run"),
                           "--steps", "1,2", "--out", str(tmp_path / "o")])


def test_unpack_then_pack_gives_the_shipped_file_back(tmp_path):
    vdir = ckpt_npz.unpack(DENOISER_NPZ, str(tmp_path / "vars"))
    unpacked = _variables_dir(vdir)
    assert all(v.dtype == np.float32 for v in unpacked.values())
    r = subprocess.run([sys.executable, "-m", "nhans_tpu_torch.tools.ckpt_npz",
                        "pack", vdir, str(tmp_path / "packed.npz")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "packed 571 tensors" in r.stdout
    got, want = _npz(tmp_path / "packed.npz"), _npz(DENOISER_NPZ)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value)


def test_pack_of_a_step_root_rounds_params_only(tmp_path):
    """A trainer's run root, float32 throughout: ``params`` come back
    within float16 rounding, ``batch_stats`` exactly, and the packed
    file has the shipped file's keys and dtypes."""
    flat = flat_variables(random_init_state(Config.denoiser()))
    rng = np.random.default_rng(0)
    flat = {k: v + rng.standard_normal(v.shape).astype(np.float32) * 1e-2
            for k, v in flat.items()}
    _steps(str(tmp_path / "ck" / "nhans"), {4: flat})
    packed = ckpt_npz.pack(str(tmp_path / "ck"), str(tmp_path / "p.npz"))
    shipped = _npz(DENOISER_NPZ)
    assert {k: v.dtype for k, v in packed.items()} == {
        k: v.dtype for k, v in shipped.items()}
    back, _ = load(ckpt_npz.unpack(str(tmp_path / "p.npz"),
                                   str(tmp_path / "back")))
    for key, value in flat.items():
        assert back[key].dtype == np.float32
        if key.startswith("batch_stats/"):
            np.testing.assert_array_equal(back[key], value)
        else:
            np.testing.assert_array_equal(
                back[key], value.astype(np.float16).astype(np.float32))
            np.testing.assert_allclose(back[key], value, rtol=2 ** -11,
                                       atol=6e-8)
