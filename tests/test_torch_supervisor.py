"""The port's ``tools/train_supervisor``: chunks from the latest complete
step to the target, and the JAX tool's retry rule (a chunk that fails
without a new checkpoint is retried up to ``--max_retries`` times in a
row; one that fails after progress goes on), checked with a stub command
in place of ``cli.train``; then two real ``cli.train`` chunks on the CPU
resume from each other."""

import json
import os
import sys

import pytest

from nhans_tpu_torch.tools import train_supervisor as sup
from nhans_tpu_torch.train.checkpoint import TRAIN_STATE
from tests.test_torch_eval_cli import _corpus

# a stand-in for cli.train: saves step --batches under --checkpoint_dir
# (the marks of an Orbax step: its tree's _METADATA under default/);
# with --fail_file it first fails (exit 3) as many times as the file says,
# and with --fail_after_save it saves and then fails
STUB = r"""
import os, sys
args = sys.argv[1:]
ck = args[args.index("--checkpoint_dir") + 1]
stop = int(args[args.index("--batches") + 1])
if "--fail_file" in args:
    path = args[args.index("--fail_file") + 1]
    left = int(open(path).read())
    if left > 0:
        open(path, "w").write(str(left - 1))
        sys.exit(3)
d = os.path.join(ck, "nhans", str(stop))
os.makedirs(os.path.join(d, "default"))
open(os.path.join(d, "default", "_METADATA"), "w").close()
open(os.path.join(d, "_CHECKPOINT_METADATA"), "w").close()
if "--fail_after_save" in args:
    sys.exit(1)
"""
COMMAND = [sys.executable, "-c", STUB]


def _fail_file(tmp_path, times):
    path = tmp_path / "fails"
    path.write_text(str(times))
    return ["--fail_file", str(path)]


def test_chunks_run_from_the_latest_step_to_the_target(tmp_path):
    rest = ["--checkpoint_dir", str(tmp_path / "ck")]
    runs = sup.supervise(5, 2, rest, command=COMMAND)
    assert runs == [(0, 2, 0), (2, 4, 0), (4, 5, 0)]
    assert sup.latest_step(str(tmp_path / "ck")) == 5
    # a rerun at the target starts nothing
    assert sup.supervise(5, 2, rest, command=COMMAND) == []


def test_latest_step_takes_complete_steps_only(tmp_path):
    """Orbax steps and the ``.npz`` steps of earlier versions of the port
    count; a half-written step (no tree ``_METADATA`` yet) and a
    temporary name do not."""
    base = tmp_path / "ck" / "nhans"
    for name, kind in (("3", "orbax"), ("2", "npz"), ("12.tmp-77", "orbax"),
                       ("9", None)):
        (base / name / "default").mkdir(parents=True)
        if kind == "orbax":
            (base / name / "default" / "_METADATA").write_text("{}")
        elif kind == "npz":
            (base / name / TRAIN_STATE).write_bytes(b"")
    assert sup.latest_step(str(tmp_path / "ck")) == 3
    (base / "5").mkdir()
    (base / "5" / TRAIN_STATE).write_bytes(b"")
    assert sup.latest_step(str(tmp_path / "ck")) == 5
    assert sup.latest_step(str(tmp_path / "absent")) == 0


def test_failures_without_progress_are_retried(tmp_path):
    rest = ["--checkpoint_dir", str(tmp_path / "ck"),
            *_fail_file(tmp_path, 2)]
    runs = sup.supervise(4, 2, rest, max_retries=3, command=COMMAND)
    assert runs == [(0, 2, 3), (0, 2, 3), (0, 2, 0), (2, 4, 0)]


def test_too_many_failures_in_a_row_exit_with_the_chunks_code(tmp_path):
    rest = ["--checkpoint_dir", str(tmp_path / "ck"),
            *_fail_file(tmp_path, 5)]
    with pytest.raises(SystemExit) as exit_info:
        sup.supervise(4, 2, rest, max_retries=2, command=COMMAND)
    assert exit_info.value.code == 3
    assert (tmp_path / "fails").read_text() == "2"  # 3 runs, all failed


def test_a_failure_after_progress_is_not_a_retry(tmp_path):
    rest = ["--checkpoint_dir", str(tmp_path / "ck"), "--fail_after_save"]
    runs = sup.supervise(3, 1, rest, max_retries=0, command=COMMAND)
    assert runs == [(0, 1, 1), (1, 2, 1), (2, 3, 1)]


def test_checkpoint_dir_is_required():
    with pytest.raises(SystemExit) as exit_info:
        sup.main(["--target", "2", "--", "--batches", "1"])
    assert exit_info.value.code == 2


def test_two_real_chunks_resume_each_other(tmp_path):
    speech, noise = _corpus(tmp_path)
    ck, summ = str(tmp_path / "ck"), str(tmp_path / "sum")
    runs = sup.main([
        "--target", "2", "--chunk", "1", "--",
        "--device", "cpu", "--speech_wav_dir", speech, "--noise_wav_dir",
        noise, "--checkpoint_dir", ck, "--summaries_dir", summ,
        "--eval_utts", "0", "--train_mb", "1", "--slices_per_step", "1",
        "--context_frames", "20", "--window_frames", "9",
        "--train_monitor_every", "1", "--eval_every", "1"])
    assert runs == [(0, 1, 0), (1, 2, 0)]
    assert sorted(os.listdir(os.path.join(ck, "nhans"))) == ["1", "2"]
    assert os.path.isfile(os.path.join(ck, "nhans", "2", "default",
                                       "_METADATA"))
    with open(os.path.join(summ, "nhans.jsonl")) as f:
        steps = [r["step"] for r in map(json.loads, f) if "loss" in r]
    assert steps == [1, 2]  # the second process took step 2 only
