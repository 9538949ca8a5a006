"""The port's public API against the JAX package's.

Completeness: every public top-level ``def``/``class`` of ``nhans_tpu/``,
every subpackage's ``__all__`` and every module that runs under
``__main__`` has its counterpart in the same module of
``nhans_tpu_torch/``, or stands in ``JAX_ONLY`` with the reason.

Parity on the CPU, on seeded inputs:
* ``stft_magphase``/``spectrogram``/``istft_from_logmag`` against JAX's
  ``impl="xla"``: magnitude within 1e-4 x max|X| (the re/im bar of
  tests/test_torch_spectral.py); log-magnitude within 1e-4 absolute where
  |X| >= 1e-3 x max|X|, and below that its exp within the magnitude's bar
  (log(|X| + 1e-5) turns a float32 sum's rounding into 1e-3 at a bin near
  zero); phase as |exp(i dphi) - 1| <= 1e-4 where |X| >= 1e-3 x max|X|
  (at the atan2 cut the raw angles differ by 2 pi, and near |X| = 0 the
  angle is rounding noise); waveforms within 1e-4 x peak;
* the windowing functions exactly (integer gathers);
* ``reverse_gradient``'s forward exactly against JAX's, and its gradient
  against ``jax.grad``; ``trunc_normal`` zero at std 0 and within two sigma;
* ``add_reference_flags``: the same option strings, defaults, choices
  and arity as JAX's, apart from the port's ``--device``;
* ``checkpoint_keys``/``load_variables`` on every checkpoint form, the
  JAX package's Orbax forms too.
"""

import ast
import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nhans_tpu.config as JC
import nhans_tpu.dsp.spectral as JS
import nhans_tpu.dsp.windowing as JW
import nhans_tpu.nn.blocks as JB
import nhans_tpu_torch.config as TC
import nhans_tpu_torch.dsp.spectral as TS
import nhans_tpu_torch.dsp.windowing as TW
import nhans_tpu_torch.nn.blocks as TB
from nhans_tpu_torch.cli._app import load_weights
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.train import checkpoint as ckpt
from nhans_tpu_torch.utils import native
from tests.make_torch_golden import DENOISER_NPZ, orbax_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = orbax_paths()

_DISPATCH = ("selects XLA or the Pallas kernel; the port dispatches by the "
             "tensor's device (ops/stft_cuda.py::log_spectrogram_kernel)")
_SHARDING = ("a jax.sharding.NamedSharding; the port's ranks take their "
             "rows with parallel/mesh.py::shard_batch")
_KERNEL = ("the TPU kernel; its counterpart is ops/stft_cuda.py::"
           "log_spectrogram_kernel (csrc/log_spectrogram.cu)")
_PROGRAMS = ("the cache of jitted programs per bucket; PyTorch runs "
             "eagerly, so there is nothing to cache")
# "<JAX module>:<qualified name>" -> why the port has no counterpart
JAX_ONLY = {
    "nhans_tpu/dsp/spectral.py:resolve_stft_impl": _DISPATCH,
    "nhans_tpu/dsp/spectral.py:_pallas_ok": _DISPATCH,
    "nhans_tpu/parallel/mesh.py:batch_sharding": _SHARDING,
    "nhans_tpu/parallel/mesh.py:replicated_sharding": _SHARDING,
    "nhans_tpu/parallel/__init__.py:batch_sharding": _SHARDING,
    "nhans_tpu/parallel/__init__.py:replicated_sharding": _SHARDING,
    "nhans_tpu/ops/stft_pallas.py:pallas_log_spectrogram": _KERNEL,
    "nhans_tpu/ops/__init__.py:pallas_log_spectrogram": _KERNEL,
    "nhans_tpu/infer/enhance.py:Enhancer._program_for": _PROGRAMS,
    "nhans_tpu/train/evaluate.py:Evaluator._program_for": _PROGRAMS,
}

JAX_MODULES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "nhans_tpu", "**", "*.py"), recursive=True))


def _parse(path):
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read())


def _is_main_guard(node) -> bool:
    return isinstance(node, ast.If) and "__main__" in ast.unparse(node.test)


def _public_api(tree, is_init: bool):
    """(public top-level names, __all__ or None, runs under __main__)."""
    names, all_, main = [], None, False
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif (is_init and isinstance(node, ast.ImportFrom)
              and (node.module or "").startswith("nhans_tpu")):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            all_ = ast.literal_eval(node.value)
        main = main or _is_main_guard(node)
    return [n for n in names if not n.startswith("_")], all_, main


def _port_module(path: str) -> str:
    mod = path[:-3].replace(os.sep, ".")
    mod = mod.replace("nhans_tpu", "nhans_tpu_torch", 1)
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


@pytest.mark.parametrize("path", JAX_MODULES)
def test_public_api_completeness(path):
    names, all_, main = _public_api(_parse(path),
                                    path.endswith("__init__.py"))
    wanted = [n for n in names + list(all_ or [])
              if f"{path}:{n}" not in JAX_ONLY]
    port_path = path.replace("nhans_tpu", "nhans_tpu_torch", 1)
    if not os.path.exists(os.path.join(REPO, port_path)):
        assert not wanted and not main, (
            f"{port_path} is missing, and {path} has {wanted}"
            + (" and a __main__ entry point" if main else ""))
        return
    port = importlib.import_module(_port_module(path))
    missing = [n for n in wanted if not hasattr(port, n)]
    assert not missing, f"{port_path} lacks {missing} of {path}"
    if all_ is not None:
        assert port.__all__ == [n for n in all_
                                if f"{path}:{n}" not in JAX_ONLY]
    if main:
        assert any(_is_main_guard(n) for n in _parse(port_path).body), (
            f"{port_path} has no __main__ entry point as {path} has")


@pytest.mark.parametrize("entry", sorted(JAX_ONLY))
def test_jax_only_names_exist_and_have_no_counterpart(entry):
    """Each JAX-only name is in the JAX package and absent from the port,
    so that the list stays true."""
    path, qualname = entry.split(":")
    scope = _parse(path).body
    for part in qualname.split("."):
        node = next((n for n in scope if getattr(n, "name", None) == part
                     or (isinstance(n, ast.ImportFrom) and part in
                         [a.asname or a.name for a in n.names])), None)
        assert node is not None, entry
        scope = getattr(node, "body", [])
    port_path = path.replace("nhans_tpu", "nhans_tpu_torch", 1)
    if os.path.exists(os.path.join(REPO, port_path)):
        obj = importlib.import_module(_port_module(path))
        for part in qualname.split("."):
            obj = getattr(obj, part, None)
        assert obj is None, f"{entry} has a counterpart now"
    assert JAX_ONLY[entry]


def test_version_matches():
    import nhans_tpu
    import nhans_tpu_torch

    assert nhans_tpu_torch.__version__ == nhans_tpu.__version__


# -- spectral -----------------------------------------------------------------

def _sig(rng, shape):
    return (rng.standard_normal(shape) * 3000.0).astype(np.float32)


def _phase_err(got, ref, mag):
    keep = mag >= 1e-3 * mag.max()
    err = np.abs(np.exp(1j * (got.astype(np.float64) - ref)) - 1.0)
    return float(err[keep].max())


@pytest.mark.parametrize("L", [4000, 16000])
@pytest.mark.parametrize("batched", [False, True])
def test_stft_magphase_matches_jax(rng, L, batched):
    x = _sig(rng, (3, L) if batched else (L,))
    mag, ph = TS.stft_magphase(torch.from_numpy(x))
    jmag, jph = (np.asarray(a) for a in JS.stft_magphase(jnp.asarray(x)))
    assert mag.shape == ph.shape == jmag.shape
    np.testing.assert_allclose(mag.numpy(), jmag, atol=1e-4 * jmag.max())
    assert _phase_err(ph.numpy(), jph, jmag) <= 1e-4


@pytest.mark.parametrize("L", [4000, 16000])
@pytest.mark.parametrize("batched", [False, True])
def test_spectrogram_matches_jax(rng, L, batched):
    x = _sig(rng, (3, L) if batched else (L,))
    lm, ph = TS.spectrogram(torch.from_numpy(x))
    jlm, jph = (np.asarray(a) for a in
                JS.spectrogram(jnp.asarray(x), impl="xla"))
    jmag = np.asarray(JS.stft_magphase(jnp.asarray(x))[0])
    assert lm.shape == ph.shape == jlm.shape
    keep = jmag >= 1e-3 * jmag.max()
    np.testing.assert_allclose(lm.numpy()[keep], jlm[keep], atol=1e-4)
    np.testing.assert_allclose(np.exp(lm.numpy()), np.exp(jlm),
                               atol=1e-4 * jmag.max())
    assert _phase_err(ph.numpy(), jph, jmag) <= 1e-4


@pytest.mark.parametrize("L", [4000, 16000])
@pytest.mark.parametrize("batched", [False, True])
def test_istft_from_logmag_matches_jax(rng, L, batched):
    x = _sig(rng, (3, L) if batched else (L,))
    jlm, jph = (np.asarray(a) for a in
                JS.spectrogram(jnp.asarray(x), impl="xla"))
    got = TS.istft_from_logmag(torch.from_numpy(jlm.copy()),
                               torch.from_numpy(jph.copy())).numpy()
    ref = np.asarray(JS.istft_from_logmag(jnp.asarray(jlm), jnp.asarray(jph)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


# -- windowing ----------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 4, 35])
def test_pad_amounts_and_pad_for_windowing_match_jax(rng, length):
    assert TW.pad_amounts(length) == JW.pad_amounts(length)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    for axis in (-2, 0, 1, 2):
        got = TW.pad_for_windowing(torch.from_numpy(x), length, axis).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JW.pad_for_windowing(jnp.asarray(x), length,
                                                 axis)))


@pytest.mark.parametrize("length,stride", [(35, 1), (5, 2), (4, 3), (1, 1)])
def test_strided_windows_and_gather_indices_match_jax(rng, length, stride):
    x = rng.standard_normal((23, 7)).astype(np.float32)
    got = TW.strided_windows(torch.from_numpy(x), length, stride).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JW.strided_windows(jnp.asarray(x), length, stride)))
    np.testing.assert_array_equal(
        TW.window_gather_indices(11, length, stride).numpy(),
        JW.window_gather_indices(11, length, stride))


def test_rest_crop_indices_match_jax(rng):
    for start, winstart in ((0, 0), (3, 5), (10, 2), (7, 40)):
        np.testing.assert_array_equal(
            TW.rest_crop_indices(start, 20, winstart, 35).numpy(),
            np.asarray(JW.rest_crop_indices(start, 20, winstart, 35)))
    start = rng.integers(0, 30, (4, 3, 1))
    winstart = rng.integers(0, 30, (4, 3, 1))
    got = TW.rest_crop_indices(torch.from_numpy(start), 20,
                               torch.from_numpy(winstart), 35)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JW.rest_crop_indices(
            jnp.asarray(start), 20, jnp.asarray(winstart), 35)))
    # a tensor against an int, each way round
    np.testing.assert_array_equal(
        TW.rest_crop_indices(torch.from_numpy(start), 20, 12, 35).numpy(),
        np.asarray(JW.rest_crop_indices(jnp.asarray(start), 20, 12, 35)))
    np.testing.assert_array_equal(
        TW.rest_crop_indices(5, 20, torch.from_numpy(winstart), 35).numpy(),
        np.asarray(JW.rest_crop_indices(5, 20, jnp.asarray(winstart), 35)))


# -- nn -----------------------------------------------------------------------

@pytest.mark.parametrize("g", [0.5, 1.0])
def test_reverse_gradient_matches_jax(rng, g):
    x = rng.standard_normal((3, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = TB.reverse_gradient(xt, g)
    # -g*x + (g+1)*x rounds to within one float32 ulp of x, as in JAX
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(JB.reverse_gradient(jnp.asarray(x), g)))
    np.testing.assert_array_max_ulp(y.detach().numpy(), x, maxulp=1)
    (y * torch.from_numpy(w)).sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(JB.reverse_gradient(v, g) * w))(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(xt.grad.numpy(), -g * w)


@pytest.mark.parametrize("std", [0.0, 0.01, 0.5])
def test_trunc_normal_initializer(std):
    init = TB.trunc_normal(std)
    w = init((64, 33), torch.Generator().manual_seed(3))
    assert w.shape == (64, 33) and w.dtype == torch.float32
    if std == 0.0:
        assert not w.any()
        return
    assert float(w.abs().max()) <= 2 * std
    assert float(w.std()) > 0.5 * std
    again = init((64, 33), torch.Generator().manual_seed(3))
    assert torch.equal(w, again)


# -- config -------------------------------------------------------------------

def _options(add, **kw):
    import argparse

    p = argparse.ArgumentParser()
    add(p, **kw)
    return {tuple(a.option_strings): (a.default, a.choices, a.nargs)
            for a in p._actions
            if a.option_strings not in (["-h", "--help"], ["--device"])}


@pytest.mark.parametrize("kw", [dict(inference=True, task="denoiser"),
                                dict(inference=True, task="separator"),
                                dict(inference=False)])
def test_add_reference_flags_matches_jax(kw):
    assert (_options(TC.add_reference_flags, **kw)
            == _options(JC.add_reference_flags, **kw))


# -- checkpoints and the native build -----------------------------------------

def test_checkpoint_keys_and_load_variables_on_every_form(tmp_path):
    with np.load(DENOISER_NPZ) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    vdir = tmp_path / "vars"
    ckpt.save_variables(str(vdir), flat)
    step_root = tmp_path / "ck"
    for step, values in ((2, {k: v * 0 for k, v in flat.items()}),
                         (5, flat)):
        d = step_root / "nhans" / str(step)
        d.mkdir(parents=True)
        np.savez(d / ckpt.VARIABLES, **values)
        np.savez(d / ckpt.TRAIN_STATE, step=np.int64(step))
    cfg = Config.denoiser()
    forms = {DENOISER_NPZ: False, str(vdir): False,
             str(step_root / "nhans" / "5"): True, str(step_root): True,
             str(step_root / "nhans"): True}
    for form, full in forms.items():
        want = {"params", "batch_stats"} | (
            {"opt_state", "step"} if full else set())
        assert ckpt.checkpoint_keys(form) == frozenset(want), form
        variables = ckpt.load_variables(form)
        assert sorted(variables) == sorted(flat), form
        assert all(np.array_equal(variables[k], flat[k]) for k in flat), form
        state = load_weights(cfg, form)
        assert all(torch.equal(state[k], v) for k, v in
                   ckpt.from_flax(variables).items()), form
    # the JAX package's Orbax forms (tests/data/orbax, written by its own
    # save_variables and Checkpointer): a variables directory against its
    # .npz twin, and a run root, its <ckdir>/nhans and its step directory
    with np.load(ORBAX["npz"]) as z:
        twin = {k: z[k] for k in z.files}
    run = ORBAX["run"]
    step_vars = ckpt.load_variables(os.path.join(run, "nhans", "1"))
    assert sorted(step_vars) == sorted(twin)
    for form, want in ((ORBAX["variables"], twin), (run, step_vars),
                       (os.path.join(run, "nhans"), step_vars)):
        full = form != ORBAX["variables"]
        assert ckpt.checkpoint_keys(form) == frozenset(
            {"params", "batch_stats"}
            | ({"opt_state", "step"} if full else set())), form
        variables = ckpt.load_variables(form)
        assert sorted(variables) == sorted(want), form
        assert all(variables[k].dtype == np.float32
                   and np.array_equal(variables[k], v)
                   for k, v in want.items()), form
    # a directory Orbax marks as its own without the tree's _METADATA
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for fn in (ckpt.checkpoint_keys, ckpt.load_variables):
        with pytest.raises(ValueError, match="no _METADATA"):
            fn(str(orbax))
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "absent"))


def test_ensure_built(monkeypatch, capsys):
    assert native.ensure_built() is True

    def no_compiler(name):
        raise RuntimeError("no host C++ compiler found (set CXX)")

    monkeypatch.setattr(native._build, "load_host", no_compiler)
    assert native.ensure_built() is False
    assert capsys.readouterr().out == ""
    assert native.ensure_built(quiet=False) is False
    assert "no host C++ compiler" in capsys.readouterr().out
