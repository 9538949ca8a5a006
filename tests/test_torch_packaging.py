"""``pip install .`` installs the port: the wheel built from ``setup.py``
holds every module of ``nhans_tpu_torch`` and its CUDA and host sources,
its seven ``nhans_torch_*`` console scripts point at functions that
return None (a console script exits with ``sys.exit(main())``), and an
installed copy starts them with JAX and ``nhans_tpu`` blocked and builds
its native library under ``~/.cache/nhans_tpu_torch``, outside the
installed tree.  Also the loader's self-test harness, ``python -m
nhans_tpu_torch.data.loader``, against the JAX package's.

The wheel is built from a copy of the sources: setuptools writes
``build/`` and ``*.egg-info`` beside ``setup.py``."""

import ast
import configparser
import glob
import importlib
import os
import re
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
from scipy.io import wavfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {
    "nhans_torch_denoiser": "nhans_tpu_torch.cli.denoiser:main",
    "nhans_torch_separator": "nhans_tpu_torch.cli.separator:main",
    "nhans_torch_train": "nhans_tpu_torch.cli.train:console_main",
    "nhans_torch_seeds": "nhans_tpu_torch.cli.seeds:main",
    "nhans_torch_evaluate": "nhans_tpu_torch.cli.evaluate:console_main",
    "nhans_torch_load_denoiser":
        "nhans_tpu_torch.cli.load_model:console_denoiser",
    "nhans_torch_load_separator":
        "nhans_tpu_torch.cli.load_model:console_separator",
}
_IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so")


def _pip(*args, cwd):
    r = subprocess.run([sys.executable, "-m", "pip", *args,
                        "--no-deps", "--no-build-isolation", "-q"],
                       cwd=cwd, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(the wheel, an install of it with --target, a directory that
    shadows jax, jaxlib, flax and nhans_tpu with packages that refuse to
    import)."""
    root = tmp_path_factory.mktemp("pkg")
    src = root / "src"
    src.mkdir()
    shutil.copy(os.path.join(REPO, "setup.py"), src)
    for pkg in ("nhans_tpu", "nhans_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), src / pkg, ignore=_IGNORE)
    _pip("wheel", "-w", str(root / "dist"), str(src), cwd=root)
    wheel, = glob.glob(str(root / "dist" / "*.whl"))
    _pip("install", "--target", str(root / "target"), wheel, cwd=root)
    block = root / "block"
    for name in ("jax", "jaxlib", "flax", "nhans_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    return wheel, root / "target", block


def _env(installed, home):
    _, target, block = installed
    return dict(os.environ, PYTHONPATH=f"{block}{os.pathsep}{target}",
                HOME=str(home))


def test_wheel_holds_the_port_and_its_sources(installed):
    with zipfile.ZipFile(installed[0]) as z:
        names = set(z.namelist())
    want = {os.path.relpath(p, REPO) for p in
            glob.glob(os.path.join(REPO, "nhans_tpu_torch", "**", "*.py"),
                      recursive=True)}
    want |= {os.path.relpath(p, REPO) for ext in ("cu", "cpp") for p in
             glob.glob(os.path.join(REPO, "nhans_tpu_torch", "csrc",
                                    f"*.{ext}"))}
    assert {"nhans_tpu_torch/csrc/log_spectrogram.cu",
            "nhans_tpu_torch/csrc/nhans_native.cpp"} <= want
    assert not want - names, sorted(want - names)


def _returns_value(fn_node) -> bool:
    return any(isinstance(n, ast.Return) and n.value is not None
               for n in ast.walk(fn_node))


def test_console_scripts_point_at_functions_returning_none(installed):
    with zipfile.ZipFile(installed[0]) as z:
        ep, = [n for n in z.namelist() if n.endswith("entry_points.txt")]
        parser = configparser.ConfigParser()
        parser.read_string(z.read(ep).decode())
    scripts = dict(parser["console_scripts"])
    assert {k: v for k, v in scripts.items()
            if k.startswith("nhans_torch_")} == SCRIPTS
    for target in SCRIPTS.values():
        module, name = target.split(":")
        assert callable(getattr(importlib.import_module(module), name))
        with open(os.path.join(REPO, *module.split(".")) + ".py") as f:
            fn, = [n for n in ast.parse(f.read()).body
                   if isinstance(n, ast.FunctionDef) and n.name == name]
        assert not _returns_value(fn), f"{target} returns a value"


@pytest.mark.parametrize("script,needle", [
    ("nhans_torch_denoiser", "--checkpoint"),
    ("nhans_torch_train", "--data_axis"),
])
def test_installed_scripts_start_with_jax_blocked(installed, tmp_path,
                                                  script, needle):
    target = installed[1]
    r = subprocess.run([sys.executable, str(target / "bin" / script),
                        "--help"], cwd=tmp_path, env=_env(installed, tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert needle in r.stdout


def test_installed_scripts_exit_zero(installed, tmp_path):
    """Two scripts run for real: seeds writes the manifests, and
    load_denoiser, whose ``main_denoiser`` returns the output path, writes
    a fresh initialisation and still exits 0."""
    target, env = installed[1], _env(installed, tmp_path)
    split = tmp_path / "speech" / "train"
    split.mkdir(parents=True)
    wavfile.write(split / "a.wav", 16000, np.zeros(800, np.int16))
    for argv in (["nhans_torch_seeds", "--speech_wav_dir",
                  str(tmp_path / "speech")],
                 ["nhans_torch_load_denoiser", "--output",
                  str(tmp_path / "init")]):
        r = subprocess.run([sys.executable, str(target / "bin" / argv[0]),
                            *argv[1:]], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
    assert (tmp_path / "speech" / "train.json").exists()
    assert (tmp_path / "init" / "_METADATA").exists()
    assert (tmp_path / "init" / "manifest.ocdbt").exists()


_BUILD_PROBE = ("from nhans_tpu_torch.ops import _build\n"
                "from nhans_tpu_torch.utils import native\n"
                "print(_build.BUILD_DIR)\n"
                "print(native.ensure_built(quiet=False))\n"
                "print(_build.load_host('nhans_native')[1]['path'])\n")


def test_installed_copy_builds_under_the_user_cache(installed, tmp_path):
    target = installed[1]
    r = subprocess.run([sys.executable, "-c", _BUILD_PROBE], cwd=tmp_path,
                       env=_env(installed, tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    build_dir, ok, lib = r.stdout.split()
    cache = os.path.join(str(tmp_path), ".cache", "nhans_tpu_torch")
    assert build_dir == os.path.join(cache, "build")
    assert ok == "True" and lib.startswith(build_dir + os.sep)
    assert os.path.isfile(lib)
    assert not glob.glob(str(target / "**" / "*.so"), recursive=True)


def test_checkout_builds_under_the_repository():
    from nhans_tpu_torch.ops import _build

    assert _build.BUILD_DIR == os.path.join(REPO, "build", "nhans_tpu_torch")


_LINE = re.compile(r"^\[(\d+)\] +\d+\.\d\d ms +(\d+\.\d) MB "
                   r"\( *\d+\.\d MB/s\)  queue=\d+$")


def test_loader_harness_matches_jax_format(tmp_path):
    """``python -m nhans_tpu_torch.data.loader --iters 2`` on a seeded
    4-utterance corpus prints the JAX harness's line per batch, with the
    same batch size in MB."""
    from nhans_tpu_torch.data.manifest import create_seeds

    rng = np.random.default_rng(4)
    for kind in ("speech", "noise"):
        for split in ("train", "valid", "test"):
            d = tmp_path / kind / split
            d.mkdir(parents=True)
            for i in range(4 if split == "valid" else 1):
                x = rng.standard_normal(int(16000 * (0.6 + 0.2 * i))) * 2000
                wavfile.write(d / f"spk{i}_{i}.wav", 16000,
                              np.rint(x).astype(np.int16))
        create_seeds(str(tmp_path / kind))
    args = ["--iters", "2", "--batch_utts", "4", "--speech_wav_dir",
            f"{tmp_path}/speech/", "--noise_wav_dir", f"{tmp_path}/noise/"]
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.data.loader", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
        for pkg in ("nhans_tpu_torch", "nhans_tpu")}
    sizes = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        lines = [ln for ln in out.splitlines() if ln.startswith("[")]
        matches = [_LINE.match(ln) for ln in lines]
        assert len(lines) == 2 and all(matches), out
        assert [m.group(1) for m in matches] == ["0", "1"]
        sizes[pkg] = [m.group(2) for m in matches]
    assert sizes["nhans_tpu_torch"] == sizes["nhans_tpu"]
