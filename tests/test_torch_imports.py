"""The port stands alone: every module of nhans_tpu_torch imports with JAX,
flax and nhans_tpu blocked, no source of it (nor chip_smoke.py) names
them, and chip_smoke.py refuses to run without a card."""

import glob
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SOURCES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "nhans_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|nhans_tpu)(?:\.|\s|$)", re.M)

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "nhans_tpu"):
    sys.modules[name] = None
import nhans_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    nhans_tpu_torch.__path__, "nhans_tpu_torch."))
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_every_module_imports_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    # config, 12 subpackages, dsp/{spectral,mixing},
    # ops/{_build,stft_cuda}, nn/{blocks,model}, compat/weights,
    # infer/enhance,
    # utils/{device,wavio,tb_events,watchdog,scoring,pesq_np,native},
    # cli/{_app,denoiser,separator,train,seeds,evaluate},
    # data/{manifest,banks,loader,pipeline},
    # train/{optim,step,checkpoint,metrics,trainer,evaluate},
    # tools/{devtime,profile_serving,profile_training,spectrogram_anatomy,
    #        eval_checkpoints}, parallel/{mesh,sharding_rules}
    assert int(r.stdout.strip()) == 51


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_source_names_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    assert not _FORBIDDEN.search(src), path


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result line,
    and so it does alone in a directory without the rest of the repo."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, "chip_smoke.py"),
                        (tmp_path, str(tmp_path / "chip_smoke.py"))):
        if cwd == tmp_path:
            with open(os.path.join(REPO, "chip_smoke.py")) as f:
                (tmp_path / "chip_smoke.py").write_text(f.read())
        r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_golden_helpers_import_with_jax_blocked():
    """chip_smoke.py takes the golden inputs and paths from
    tests/make_torch_golden.py, whose JAX imports stay inside the function
    that runs the JAX package."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'nhans_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from tests.make_torch_golden import (DENOISER_NPZ, GOLDEN,\n"
            "    GOLDEN_EVAL, SEPARATOR_NPZ, eval_digest,\n"
            "    golden_eval_examples, golden_inputs, input_digest,\n"
            "    port_eval_golden)\n"
            "print(input_digest(*golden_inputs()))\n"
            "print(eval_digest(golden_eval_examples()))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert [len(line) for line in r.stdout.split()] == [64, 64]
