"""The training options the port took over from the JAX trainer: the
command line builds a trainer for ``--dtype bfloat16``, ``--remat``,
``--freq_pad_to 256`` and ``--profile_dir`` on ``--device cpu`` with the
model they select, and ``--profile_dir`` writes a torch.profiler trace of
steps 10 to 20 (of what ran, when training ends first).  The trainer runs
a reduced model on the tiny corpus of tests/test_torch_trainer.py."""

import dataclasses
import json
import os

import pytest
import torch

from nhans_tpu_torch.cli import train as cli_train
from nhans_tpu_torch.train.trainer import Trainer
from tests.test_torch_trainer import _cfg, _corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags,check", [
    (["--dtype", "bfloat16"],
     lambda t: (t.cfg.model.compute_dtype == "bfloat16"
                and t.model.resblock1.conv1.dtype == torch.bfloat16
                and t.evaluator.model.last_dense.dtype == torch.bfloat16
                and {p.dtype for p in t.model.parameters()}
                == {torch.float32})),
    (["--remat"], lambda t: t.cfg.model.remat and t.model.cfg.remat),
    (["--freq_pad_to", "256"],
     lambda t: (t.model.freq_pad == 256
                and t.evaluator.model.resblock1.freq_valid == 201)),
    (["--profile_dir", "PROFILE"],
     lambda t: t.cfg.train.profile_dir.endswith("PROFILE")),
])
def test_cli_builds_a_trainer_for_each_option(tmp_path, capsys, flags,
                                              check):
    speech, noise = _corpus(tmp_path)
    flags = [str(tmp_path / f) if f == "PROFILE" else f for f in flags]
    trainer = cli_train.build_trainer(
        ["--device", "cpu", "--speech_wav_dir", speech, "--noise_wav_dir",
         noise, "--checkpoint_dir", str(tmp_path / "ck"), "--summaries_dir",
         str(tmp_path / "s"), "--eval_utts", "0", "--context_frames", "20",
         "--window_frames", "9", *flags])
    assert check(trainer)


@pytest.mark.parametrize("batches,last", [(21, 20), (13, 13)])
def test_profile_dir_writes_a_trace(tmp_path, capsys, batches, last):
    cfg = _cfg(tmp_path, alg="sgd", batches=batches)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, profile_dir=str(tmp_path / "prof")))
    trainer = Trainer(cfg, eval_utts=0, device="cpu")
    trainer.train()
    assert trainer.tstep == batches
    assert trainer.trace_path == str(tmp_path / "prof" /
                                     f"nhans_steps_10_{last}.json")
    assert os.listdir(tmp_path / "prof") == [os.path.basename(
        trainer.trace_path)]
    with open(trainer.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the traced steps ran convolutions
    assert any("conv" in n for n in names)
    assert (f"profiler trace written to {tmp_path / 'prof'}"
            in capsys.readouterr().out)
