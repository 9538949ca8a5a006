"""The port's trainer on the CPU: the corpus banks' index stream
against the JAX package's, the streaming loader, checkpoints with
auto-resume, --restore_path, the scoring at each save (synchronous and
on a thread, and the all-zero record of --eval_utts 0), and the training
command line.

The trainer runs a reduced model on a tiny seeded corpus under tmp_path.
Two steps, a checkpoint, an auto-resumed trainer and two more steps give
the same parameters, statistics and optimizer state as four
uninterrupted steps, bit for bit: every draw of a step is a pure function
of (seed, step) and the CPU kernels are deterministic.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from nhans_tpu.data.banks import BankIndexLoader as JBankIndexLoader
from nhans_tpu.data.banks import DeviceBanks as JDeviceBanks
from nhans_tpu_torch.cli import train as cli_train
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.data import loader as data_loader
from nhans_tpu_torch.data.banks import (BankIndexLoader, DeviceBanks,
                                        banks_enabled)
from nhans_tpu_torch.data.loader import TrainLoader, bucket_length
from nhans_tpu_torch.data.manifest import create_seeds
from nhans_tpu_torch.models import init_variables
from nhans_tpu_torch.tools import eval_checkpoints
from nhans_tpu_torch.train import checkpoint as ckpt
from nhans_tpu_torch.train import trainer as trainer_mod
from nhans_tpu_torch.train.step import create_state
from nhans_tpu_torch.train.trainer import Trainer
from tests.make_torch_golden import twin_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_MODEL = dict(
    window_frames=9, context_frames=20, embedding_dim=16,
    pos_embed_hidden=8,
    main_blocks=((3, 1, 8), (3, 2, 16)),
    context_blocks=(((4, 4), (2, 2), 8), ((3, 3), (1, 2), 16)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    a pool that contends for the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(root, n_train=5, seconds=(0.6, 1.1, 0.45, 0.9, 1.3)):
    """speech/ and noise/ trees of int16 wavs with train/valid/test
    manifests; speech files are named spk<i % 3>_u<i>.wav."""
    rng = np.random.default_rng(0)
    dirs = []
    for kind in ("speech", "noise"):
        base = os.path.join(str(root), kind)
        for split, n in (("train", n_train), ("valid", 2), ("test", 1)):
            d = os.path.join(base, split)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                x = rng.standard_normal(int(seconds[i % len(seconds)]
                                            * 16000)) * 3000
                if kind == "speech":
                    x += 6000 * np.sin(2 * np.pi * (140 + 30 * i)
                                       * np.arange(len(x)) / 16000)
                wavfile.write(os.path.join(d, f"spk{i % 3}_u{i}.wav"),
                              16000, np.rint(x).astype(np.int16))
        create_seeds(base)
        dirs.append(base + "/")
    return dirs


def _cfg(tmp_path, task="denoiser", **train):
    speech, noise = _corpus(tmp_path / "corpus")
    _, cfg = twin_configs(
        task, model=SMALL_MODEL,
        data=dict(speech_wav_dir=speech, noise_wav_dir=noise,
                  max_samples=16000, length_buckets=(0.7, 1.0),
                  slices_per_step=2, num_workers=2, seed=3),
        train=dict(dict(alg="adam", lr=1e-3, train_mb=4, batches=4,
                        eval_every=1000, train_monitor_every=1,
                        eval_after_training=False,
                        checkpoint_dir=str(tmp_path / "ck"),
                        summaries_dir=str(tmp_path / "sum"),
                        wav_dump_folder=str(tmp_path / "wavs"),
                        dump_results=""), **train))
    return cfg


def _records(cfg):
    path = os.path.join(cfg.train.summaries_dir, "nhans.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _eval_records(cfg):
    """(step, metrics) of each evaluation record, in order."""
    return [(r["step"], {k: v for k, v in r.items()
                         if k not in ("step", "time")})
            for r in _records(cfg) if "eval_loss" in r]


# the keys of the JAX evaluator's metrics
JAX_KEYS = {"eval_loss", "si_sdr", "si_sdr_mixed", "si_sdr_gain",
            "si_sdr_interferer", "confused_utts", "stoi", "stoi_mixed",
            "estoi", "estoi_mixed", "pesq"}


@pytest.mark.parametrize("task", ["denoiser", "separator"])
def test_bank_index_stream_equals_jax(tmp_path, task):
    speech, noise = _corpus(tmp_path)
    jcfg, tcfg = twin_configs(task, data=dict(
        speech_wav_dir=speech, noise_wav_dir=noise, seed=7))
    jl = JBankIndexLoader(JDeviceBanks(jcfg), 6, start_step=5)
    tl = BankIndexLoader(DeviceBanks(tcfg, "cpu"), 6, start_step=5)
    for _ in range(4):
        want, got = next(jl), next(tl)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_banks_hold_the_corpus(tmp_path):
    cfg = _cfg(tmp_path)
    banks = DeviceBanks(cfg, "cpu")
    assert banks_enabled(cfg)
    sp = banks.banks["speech"]
    assert sp.dtype == torch.int16
    assert (sp.shape[1] - 400) % 160 == 0  # whole frames
    for i, path in enumerate(banks.speech_paths):
        x = wavfile.read(path)[1]
        n = min(len(x), cfg.data.max_samples)
        assert int(banks.banks["speech_len"][i]) == n
        np.testing.assert_array_equal(sp[i, :n].numpy(), x[:n])
        assert float(banks.banks["speech_peak"][i]) == np.abs(x).max()
    off = dataclasses.replace(cfg.data, device_corpus="off")
    assert not banks_enabled(cfg.replace(data=off))
    small = dataclasses.replace(cfg.data, device_corpus="on",
                                device_corpus_mb=0)
    with pytest.raises(ValueError):
        banks_enabled(cfg.replace(data=small))


@pytest.mark.parametrize("task", ["denoiser", "separator"])
def test_streaming_loader_batches(tmp_path, task):
    cfg = _cfg(tmp_path, task)
    loader = TrainLoader(cfg, 3)
    try:
        for _ in range(3):
            b = next(loader)
            L = b["clean"].shape[1]
            assert L == bucket_length(cfg, int(b["clean_len"].max()))
            assert b["clean"].dtype == np.int16
            for buf, ln in (("clean", "clean_len"), ("noise_a", "len_a")):
                assert (b[ln] <= L).all() and (b[ln] > 0).all()
                for r in range(3):
                    assert not b[buf][r, b[ln][r]:].any()
            # whole-file peaks: at least the buffer's
            assert (b["peaks"][:, 0] >= np.abs(b["clean"]).max(1)).all()
            assert (b["peaks"][:, 1] >= np.abs(b["noise_a"]).max(1)).all()
            if task == "separator":
                assert not b["noise_b"].any() and not b["len_b"].any()
    finally:
        loader.close()


def _params(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def test_resume_replays_an_uninterrupted_run(tmp_path):
    cfg = _cfg(tmp_path / "a")
    full = Trainer(cfg, eval_utts=0, device="cpu")
    assert full.banked
    full.train()
    assert full.tstep == 4

    cfg2 = _cfg(tmp_path / "b", batches=2, eval_every=2)
    first = Trainer(cfg2, eval_utts=0, device="cpu")
    first.train()
    assert first.ckpt.latest_step() == 2
    resumed = Trainer(cfg2.replace(train=dataclasses.replace(
        cfg2.train, batches=4)), eval_utts=0, device="cpu")
    assert resumed.tstep == 2
    resumed.train()
    assert resumed.tstep == 4
    want, got = _params(full), _params(resumed)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for slot in ("mu", "nu"):
        for k, v in full.state.opt_state[slot].items():
            assert torch.equal(resumed.state.opt_state[slot][k], v), k
    # the monitor wrote every step's loss; the resumed ones match (the
    # save at step 2 also wrote an evaluation record, without a loss)
    def losses(c):
        return {r["step"]: r["loss"] for r in _records(c) if "loss" in r}
    assert losses(cfg)[3] == losses(cfg2)[3]
    assert losses(cfg)[4] == losses(cfg2)[4]


def test_checkpoint_layout_keep_k_and_restore_path(tmp_path):
    cfg = _cfg(tmp_path, batches=3, eval_every=1, checkpoints_to_keep=2,
               alg="rmsprop")
    tr = Trainer(cfg, eval_utts=0, device="cpu")
    tr.train()
    assert tr.ckpt.steps() == [2, 3]
    step_dir = os.path.join(tr.ckpt.path, "3")
    # serving reads a step directory's variables as a flat .npz
    from nhans_tpu_torch.compat.weights import load_npz
    state = load_npz(os.path.join(step_dir, ckpt.VARIABLES))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(state[k], v), k
    variables, extra = ckpt.load(os.path.join(tmp_path, "ck"))
    assert int(extra["step"]) == 3 and str(extra["alg"]) == "rmsprop"

    # a flat .npz: the variables, a fresh optimizer, step 0
    npz = os.path.join(step_dir, ckpt.VARIABLES)
    fresh = dataclasses.replace(cfg.train, restore_path=npz,
                                checkpoint_dir=str(tmp_path / "ck2"))
    tuned = Trainer(cfg.replace(train=fresh), eval_utts=0, device="cpu")
    assert tuned.tstep == 0 and tuned.state.opt_state["count"] == 0
    assert all(bool((v == 1).all())
               for v in tuned.state.opt_state["nu"].values())
    for k, v in tr.model.state_dict().items():
        assert torch.equal(tuned.model.state_dict()[k], v), k
    # a step directory: the full state
    full = dataclasses.replace(fresh, restore_path=step_dir)
    cont = Trainer(cfg.replace(train=full), eval_utts=0, device="cpu")
    assert cont.tstep == 3 and cont.state.opt_state["count"] == 3
    # an Orbax directory of the JAX package is refused
    orbax = tmp_path / "orbax" / "7"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        ckpt.load(str(orbax))


def test_streaming_trainer_runs(tmp_path):
    cfg = _cfg(tmp_path, batches=2, eval_after_training=True)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               device_corpus="off"))
    tr = Trainer(cfg, eval_utts=0, device="cpu")
    assert not tr.banked
    before = _params(tr)
    tr.train()
    after = _params(tr)
    assert tr.ckpt.latest_step() == 2
    assert not torch.equal(before["resblock1.conv1.w"],
                           after["resblock1.conv1.w"])
    assert not torch.equal(before["resblock1.bn1.pop_mean"],
                           after["resblock1.bn1.pop_mean"])


def test_save_and_eval_scores_the_saved_weights(tmp_path, monkeypatch):
    """--eval_utts 2 with eval_after_training: a record with the JAX
    evaluator's keys at the last step, which tools/eval_checkpoints
    (Evaluator.run on the checkpoint written there) gives again; the
    training module stays in training."""
    cfg = _cfg(tmp_path, batches=2, eval_after_training=True)
    tr = Trainer(cfg, eval_utts=2, device="cpu")
    tr.train()
    (step, got), = _eval_records(cfg)
    assert step == 2
    assert {"eval_loss", "si_sdr", "si_sdr_mixed", "si_sdr_gain"} <= set(got)
    assert set(got) <= JAX_KEYS
    assert got["eval_loss"] > 0
    assert tr.model.training
    assert len(os.listdir(cfg.train.wav_dump_folder)) == 2 * 5
    monkeypatch.setattr(Config, "denoiser", staticmethod(lambda: cfg))
    swept = eval_checkpoints.main([
        "--task", "denoiser", "--device", "cpu", "--eval_utts", "2",
        "--checkpoint_root", tr.ckpt.path,
        "--speech_wav_dir", cfg.data.speech_wav_dir,
        "--noise_wav_dir", cfg.data.noise_wav_dir,
        "--eval_seeds", "valid", "--jsonl", str(tmp_path / "sweep.jsonl")])
    assert [r["step"] for r in swept] == [2]
    assert {k: v for k, v in swept[0].items() if k != "step"} == \
        pytest.approx(got, rel=1e-12)
    assert len(open(tmp_path / "sweep.jsonl").readlines()) == 1


def test_async_eval_gives_the_synchronous_records(tmp_path, monkeypatch):
    """Saves at steps 2 and 4, scored on a thread with --async_eval (while
    steps 3 and 4 train) and in the loop without: the records agree."""
    where = []
    sync_eval = Trainer._eval

    def eval_and_note(self, step, loader=None):
        where.append((self.cfg.train.async_eval, step,
                      threading.current_thread() is threading.main_thread()))
        sync_eval(self, step, loader)

    monkeypatch.setattr(Trainer, "_eval", eval_and_note)
    # one corpus: the evaluation SNRs come from the md5 of the clean path
    base = _cfg(tmp_path, eval_every=2)
    records = {}
    for mode in (False, True):
        cfg = base.replace(train=dataclasses.replace(
            base.train, async_eval=mode,
            checkpoint_dir=str(tmp_path / f"ck_{mode}"),
            summaries_dir=str(tmp_path / f"sum_{mode}"),
            wav_dump_folder=str(tmp_path / f"wavs_{mode}")))
        tr = Trainer(cfg, eval_utts=2, device="cpu",
                     eval_kwargs=dict(eval_batch=2, buckets_seconds=(1.5,)))
        tr.train()
        assert tr._eval_thread is None  # joined at shutdown
        records[mode] = _eval_records(cfg)
    assert where == [(False, 2, True), (False, 4, True),
                     (True, 2, False), (True, 4, False)]
    assert [s for s, _ in records[False]] == [2, 4]
    assert [s for s, _ in records[True]] == [2, 4]
    for (_, want), (_, got) in zip(records[False], records[True]):
        assert got == pytest.approx(want, rel=1e-12)


def test_eval_utts_zero_writes_zeros_and_reads_no_eval_data(tmp_path,
                                                            monkeypatch):
    """The JAX trainer's record for no utterances at every save; unlike
    the JAX trainer, no EvalLoader is built, so no eval manifest is read
    and nothing is decoded for it."""
    def refuse(*args, **kwargs):
        raise AssertionError("evaluation data read with --eval_utts 0")

    monkeypatch.setattr(trainer_mod, "EvalLoader", refuse)
    monkeypatch.setattr(data_loader, "_decode", refuse)
    cfg = _cfg(tmp_path, batches=2, eval_every=1, eval_after_training=True)
    for kind in ("speech", "noise"):
        os.remove(os.path.join(getattr(cfg.data, f"{kind}_wav_dir"),
                               "valid.json"))
    Trainer(cfg, eval_utts=0, device="cpu").train()
    zeros = {"eval_loss": 0.0, "si_sdr": 0.0, "si_sdr_mixed": 0.0,
             "si_sdr_gain": 0.0}
    assert _eval_records(cfg) == [(1, zeros), (2, zeros), (2, zeros)]
    assert not os.path.exists(cfg.train.wav_dump_folder)


@pytest.mark.parametrize("flags", [
    ["--data_axis", "2"], ["--model_axis", "2"], ["--multihost"]])
def test_cli_refusals_are_messages(tmp_path, capsys, flags):
    """A mesh that the world (one process here) cannot hold, and
    --multihost without its three flags, exit with a message naming
    them; the mesh itself is tested on several processes in
    tests/test_torch_parallel_*.py."""
    speech, noise = _corpus(tmp_path)
    with pytest.raises(SystemExit) as exit_info:
        cli_train.build_trainer(
            ["--device", "cpu", "--speech_wav_dir", speech,
             "--noise_wav_dir", noise, "--checkpoint_dir",
             str(tmp_path / "ck"), "--summaries_dir", str(tmp_path / "s"),
             *flags])
    msg = str(exit_info.value.code)
    if flags == ["--multihost"]:
        assert "--coordinator" in msg and "--num_processes" in msg
    else:
        data = "2" if flags[0] == "--data_axis" else "0"
        model = "2" if flags[0] == "--model_axis" else "1"
        assert f"--data_axis {data} x --model_axis {model}" in msg
        assert "the world has 1" in msg


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, capsys):
    speech, noise = _corpus(tmp_path)
    with pytest.raises(SystemExit) as exit_info:
        cli_train.build_trainer(["--speech_wav_dir", speech,
                                 "--noise_wav_dir", noise, "--eval_utts",
                                 "0"])
    assert "--device cpu" in str(exit_info.value.code)
    # the library entry points too: the card unless device="cpu"
    _, cfg = twin_configs("denoiser", model=SMALL_MODEL)
    g = torch.Generator()
    for make in (create_state, init_variables):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg, g)
    _, state, _ = create_state(cfg, g, "cpu")
    assert {t.device.type for t in state.params.values()} == {"cpu"}


def test_cli_trains_on_the_cpu_and_refuses_without_a_card(tmp_path):
    """The command line end to end in its own process: one step at the
    full channel widths (short windows and contexts) and a checkpoint;
    without a card and without --device cpu it exits with a message and
    no traceback."""
    speech, noise = _corpus(tmp_path)
    common = ["--speech_wav_dir", speech, "--noise_wav_dir", noise,
              "--checkpoint_dir", str(tmp_path / "ck"), "--summaries_dir",
              str(tmp_path / "sum"), "--eval_utts", "0", "--batches", "1",
              "--train_mb", "1", "--slices_per_step", "1",
              "--context_frames", "20", "--window_frames", "9",
              "--train_monitor_every", "1", "--alg", "sgd"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "nhans_tpu_torch.cli.train",
                        *common], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr and "Traceback" not in r.stderr
    r = subprocess.run([sys.executable, "-m", "nhans_tpu_torch.cli.train",
                        "--device", "cpu", *common], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "step number: 1" in r.stdout
    assert os.path.isdir(tmp_path / "ck" / "nhans" / "1")
