"""The training and evaluation command lines with evaluation, on the CPU
at the full channel widths: ``cli.train`` with its default evaluation
flags trains, scores its checkpoint and writes the record;
``cli.evaluate`` on that checkpoint prints the same metrics;
``--async_eval`` is taken; ``cli.evaluate`` with a path that holds no
checkpoint or without a card exits with a message.

The default buckets put every utterance on a 4 s bucket (398 frames) in
groups of 8, so the runs cut the windows with 380-frame contexts and
9-frame windows: 18 windows a row, 13 of them valid for the 3.95 s
utterance."""

import json
import os

import numpy as np
import pytest
from scipy.io import wavfile

from nhans_tpu_torch.cli import evaluate as cli_evaluate
from nhans_tpu_torch.cli import train as cli_train
from nhans_tpu_torch.data.manifest import create_seeds

CUTS = ["--context_frames", "380", "--window_frames", "9"]


def _corpus(root):
    """speech/ and noise/ with two train and two valid files each; the
    valid speech of 3.95 and 1.2 s."""
    rng = np.random.default_rng(4)
    dirs = []
    for kind in ("speech", "noise"):
        base = os.path.join(str(root), kind)
        for split, seconds in (("train", (0.7, 1.0)), ("valid", (3.95, 1.2)),
                               ("test", (0.5,))):
            os.makedirs(os.path.join(base, split))
            for i, sec in enumerate(seconds):
                n = int(sec * 16000)
                x = rng.standard_normal(n) * 2000
                if kind == "speech":
                    x += 6000 * np.sin(2 * np.pi * (150 + 40 * i)
                                       * np.arange(n) / 16000)
                wavfile.write(os.path.join(base, split, f"spk{i}_u{i}.wav"),
                              16000, np.rint(x).astype(np.int16))
        create_seeds(base)
        dirs.append(base + "/")
    return dirs


def _printed(stdout: str, names) -> dict:
    """The last ``name: value`` lines of ``stdout``, one per name."""
    lines = stdout.splitlines()[-len(names):]
    return {name: float(value) for name, _, value in
            (line.partition(": ") for line in lines)}


def test_cli_train_scores_by_default_and_cli_evaluate_agrees(tmp_path,
                                                             capsys):
    speech, noise = _corpus(tmp_path)
    data = ["--speech_wav_dir", speech, "--noise_wav_dir", noise,
            "--wav_dump_folder", str(tmp_path / "wavs"),
            "--dump_results", str(tmp_path / "dump"), *CUTS]
    trainer = cli_train.build_trainer([
        "--device", "cpu", *data, "--checkpoint_dir", str(tmp_path / "ck"),
        "--summaries_dir", str(tmp_path / "sum"), "--batches", "1",
        "--train_mb", "1", "--slices_per_step", "1", "--alg", "sgd",
        "--train_monitor_every", "1"])
    assert trainer.eval_utts == 16 and trainer.cfg.train.eval_after_training
    trainer.train()
    (step, record), = [(s, r) for s, r in _records(tmp_path / "sum")
                       if "eval_loss" in r]
    assert step == 1
    assert {"eval_loss", "si_sdr", "si_sdr_mixed", "si_sdr_gain"} <= set(
        record)
    assert record["eval_loss"] > 0
    # 2 utterances x 5 reconstructions; per-window losses and waveforms
    assert len(os.listdir(tmp_path / "wavs")) == 10
    assert len(os.listdir(tmp_path / "dump")) == 12
    capsys.readouterr()

    metrics = cli_evaluate.main(["--device", "cpu", "--checkpoint",
                                 str(tmp_path / "ck" / "nhans" / "1"),
                                 *data])
    out = capsys.readouterr().out
    assert "valid" in out.splitlines()
    assert _printed(out, metrics) == pytest.approx(metrics, rel=1e-12)
    assert metrics == pytest.approx(record, rel=1e-9)


def _records(summaries):
    with open(os.path.join(summaries, "nhans.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r.pop("step"), {k: v for k, v in r.items() if k != "time"})
            for r in recs]


def test_cli_train_takes_async_eval(tmp_path):
    speech, noise = _corpus(tmp_path)
    trainer = cli_train.build_trainer([
        "--device", "cpu", "--speech_wav_dir", speech, "--noise_wav_dir",
        noise, "--checkpoint_dir", str(tmp_path / "ck"), "--summaries_dir",
        str(tmp_path / "sum"), "--async_eval", *CUTS])
    assert trainer.cfg.train.async_eval
    trainer.writer.close()


@pytest.mark.parametrize("flags, needle", [
    (["--device", "cpu", "--checkpoint", "no/such/checkpoint"],
     "no checkpoint at"),
    (["--checkpoint", "docs/quality/denoiser_q5_swa.npz"], "--device cpu"),
])
def test_cli_evaluate_refusals_are_messages(flags, needle):
    """A checkpoint path that holds none.  No card (this machine) and no
    --device cpu."""
    with pytest.raises(SystemExit) as exit_info:
        cli_evaluate.main(flags)
    assert needle in str(exit_info.value.code)
