"""The port's trainer and training command line on two CPU processes
(gloo; ``tests/make_torch_golden.py::run_ranks``), as
tests/test_multihost.py runs the JAX package's on a 2-process cluster.

* A 2-rank ``Trainer`` on the banked corpus trains 4 steps and saves from
  rank 0 (with an evaluation there, on rank 0 only), and a second Trainer
  on both ranks auto-resumes at step 4 with the saved weights.  Its
  global batch is the 1-rank run's, so its losses and weights equal a
  1-rank run's: losses 1e-5 relative, weights and statistics 1e-5 + 1e-4
  relative (sums over two ranks in another order).  The runs take sgd
  steps: Adam moves the biases whose exact gradient is zero by +-lr in
  the sign of their rounding noise, which differs between the two.
* On the streaming path each rank reads its shard of the manifest.
* ``cli.train --multihost ... --data_axis 3`` on a world of 2 exits with
  a message naming both sizes, on every rank, with no traceback.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from nhans_tpu_torch.compat.weights import to_flax
from nhans_tpu_torch.data.loader import TrainLoader
from nhans_tpu_torch.train.trainer import Trainer
from tests.make_torch_golden import REPO, run_ranks
from tests.test_torch_trainer import _cfg, _corpus, _records

RANKS_TIMEOUT = 110


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_rank_trainer_saves_on_rank_0_and_resumes(tmp_path):
    cfg = _cfg(tmp_path / "two", alg="sgd", lr=1e-2,
               eval_after_training=True)
    spec = dict(cfg=cfg, eval_utts=1, out=str(tmp_path / "tr"),
                eval_kwargs=dict(eval_batch=1, buckets_seconds=(1.5,)))
    with open(tmp_path / "tr.pkl", "wb") as f:
        pickle.dump(spec, f)
    run_ranks(2, "tests.make_torch_golden:rank_trainer",
              str(tmp_path / "tr.pkl"), timeout=RANKS_TIMEOUT,
              env={"OMP_NUM_THREADS": "1"})
    outs = [dict(np.load(tmp_path / f"tr.{r}.npz")) for r in range(2)]
    for out in outs:
        assert int(out["tstep"]) == 4 and int(out["resumed"]) == 4
        assert bool(out["banked"])
        assert int(out["batch_utts"]) == 2 and int(out["local_utts"]) == 1
    assert [bool(o["evaluator"]) for o in outs] == [True, False]
    # one checkpoint, one metrics record (rank 0's), one evaluation
    assert sorted(os.listdir(tmp_path / "two" / "ck" / "nhans")) == ["4"]
    recs = _records(cfg)
    assert [r["step"] for r in recs if "eval_loss" in r] == [4]

    one_cfg = _cfg(tmp_path / "one", alg="sgd", lr=1e-2)
    one = Trainer(one_cfg, eval_utts=0, device="cpu")
    one.train()
    want = {r["step"]: r["loss"] for r in _records(one_cfg) if "loss" in r}
    got = {r["step"]: r["loss"] for r in recs if "loss" in r}
    assert sorted(got) == [1, 2, 3, 4]
    for step, loss in want.items():
        np.testing.assert_allclose(got[step], loss, rtol=1e-5)
    params = {f"params/{k}": v.numpy()
              for k, v in one.model.state_dict().items()}
    for out in outs:  # the resumed weights are the saved ones, on each rank
        for k, v in params.items():
            np.testing.assert_allclose(out[k], v, atol=1e-5, rtol=1e-4,
                                       err_msg=k)


def test_streaming_loader_reads_its_shard_of_the_manifest(tmp_path):
    cfg = _cfg(tmp_path, task="separator")
    loaders = [TrainLoader(cfg, 2, shard=(i, 2), num_workers=1)
               for i in range(2)]
    try:
        full = loaders[0]._speech_full
        assert loaders[0].speech == full[0::2]
        assert loaders[1].speech == full[1::2]
        for loader in loaders:
            batch = next(loader)
            assert batch["clean"].shape[0] == 2
            # interferers come from the whole manifest, another voice
            assert len(loader._other) == len(full)
    finally:
        for loader in loaders:
            loader.close()


def test_cli_mesh_larger_than_the_world_is_a_message(tmp_path):
    speech, noise = _corpus(tmp_path)
    store = f"file://{tmp_path}/store"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nhans_tpu_torch.cli.train", "--device", "cpu",
         "--multihost", "--coordinator", store, "--num_processes", "2",
         "--process_id", str(r), "--data_axis", "3",
         "--speech_wav_dir", speech, "--noise_wav_dir", noise,
         "--checkpoint_dir", str(tmp_path / "ck"),
         "--summaries_dir", str(tmp_path / "sum")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=RANKS_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode != 0
        assert "--data_axis 3 x --model_axis 1" in err, err
        assert "the world has 2" in err and "Traceback" not in err, err


def test_checkpoint_of_a_model_axis_run_holds_full_tensors(tmp_path):
    """``load_into`` cuts a full checkpoint's kernels to a rank's block,
    and ``cut_shard``/``join_shards`` invert each other, so a
    ``model_axis=2`` run starts from full weights (the JAX package's, or
    a 1-card checkpoint) and its checkpoints load on one card."""
    from nhans_tpu_torch.compat.weights import cut_shard, join_shards
    from nhans_tpu_torch.models import build_model
    from nhans_tpu_torch.parallel.mesh import Mesh
    from nhans_tpu_torch.parallel.sharding_rules import shard_model
    from nhans_tpu_torch.train.checkpoint import load_into

    cfg = _cfg(tmp_path)
    g = torch.Generator()
    g.manual_seed(0)
    full = build_model(cfg)
    for p in full.parameters():
        with torch.no_grad():
            p.normal_(generator=g)
    flat = {**to_flax(dict(full.named_parameters()), "params"),
            **to_flax(dict(full.named_buffers()), "batch_stats")}
    blocks = []
    for index in range(2):
        part = build_model(cfg)
        picked = shard_model(part, Mesh(data=1, model=2, rank=index),
                             min_channels=16)
        load_into(part, flat)
        blocks.append(dict(part.named_parameters()))
    assert picked and all(d in (0, 1) for d in picked.values())
    for name, dim in picked.items():
        w = dict(full.named_parameters())[name].detach()
        joined = join_shards([b[name].detach() for b in blocks], dim)
        assert torch.equal(joined, w), name
        assert torch.equal(cut_shard(w, dim, 1, 2), blocks[1][name]), name
    assert torch.equal(blocks[0]["last_dense.w"],
                       dict(full.named_parameters())["last_dense.w"])
