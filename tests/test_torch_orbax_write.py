"""The port writes the JAX package's Orbax checkpoints
(``nhans_tpu_torch/compat/orbax.py``, ``train/checkpoint.py``), and the
JAX package, orbax and tensorstore read them on the CPU.

The port writes in ``tmp_path`` at the narrow widths of the committed
fixtures (``tests/make_torch_golden.py``: ``ORBAX_MODEL``, the full-width
model's 571 names) and, for the shipped weights, at full width.  The JAX
package's own ``load_variables``, ``checkpoint_keys``,
``Checkpointer.restore(template=...)`` and ``Trainer`` restore what it
wrote bit-exactly; a step resumed from it is held to the port's next
step with the bars of ``chip_smoke.py``'s phase 8
(``tests/test_torch_orbax.py::_within_phase8_bars``)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from nhans_tpu.train import checkpoint as jckpt
from nhans_tpu_torch.compat import orbax
from nhans_tpu_torch.compat.weights import from_flax, to_flax
from nhans_tpu_torch.tools import train_supervisor
from nhans_tpu_torch.train import checkpoint as ckpt
from nhans_tpu_torch.train.step import TrainState
from nhans_tpu_torch.utils import zstd
from tests.make_torch_golden import (DENOISER_NPZ, ORBAX_SEED, TRAIN_SLICES,
                                     jax_next_step, jax_orbax_config,
                                     jax_orbax_state, jax_variables,
                                     port_orbax_step, port_orbax_trainer)
from tests.test_torch_orbax import (ALGS, FIXTURES, _exact, _flat,
                                    _save_state, _twin, _within_phase8_bars)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every optax tree the JAX trainer can hold: --alg, lr a schedule or not,
# and rmsprop with and without --mom
COMBOS = [(alg, scheduled, mom) for alg in ALGS for scheduled in (False, True)
          for mom in ((0.0, 0.9) if alg == "rmsprop" else (0.9,))]


def _flags(scheduled: bool, mom: float) -> tuple:
    sched = (("--lr_schedule", "cosine", "--lr_decay_steps", "100")
             if scheduled else ())
    return ("--lr", "1e-3", *sched, "--mom", str(mom), "--slices_per_step",
            str(TRAIN_SLICES))


def _abstract(tree):
    """The JAX trainer's restore template: shapes and dtypes."""
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.result_type(x)), tree)


def _port_state(state) -> TrainState:
    """The port's ``TrainState`` of a JAX one, slot by optax field name
    (independent of the port's reader)."""
    flat = _flat(state)
    step = int(flat["step"])
    params, stats, slots = {}, {}, {}
    for key, value in flat.items():
        coll, _, rest = key.partition("/")
        if coll == "params":
            params[key] = value
        elif coll == "batch_stats":
            stats[key] = value
        elif coll == "opt_state":
            _, field, *path = rest.split("/")
            if field == "count":
                assert int(value) == step, key
            else:
                slots.setdefault(field, {})["params/" + "/".join(path)] = value
    opt = {"count": step, **{s: from_flax(f) for s, f in slots.items()}}
    return TrainState(step=step, params=from_flax(params),
                      batch_stats=from_flax(stats), opt_state=opt)


def _same_tree(got, want, what: str) -> None:
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want)), what
    _exact(_flat(got), _flat(want), what)


def _tree_files(path: str) -> dict:
    """The ``_METADATA`` and every ``.zarray`` of an Orbax tree, and its
    store's keys."""
    store = orbax.OcdbtStore(path)
    with open(os.path.join(path, orbax.METADATA)) as f:
        meta = json.load(f)
    return {"meta": meta, "order": list(meta["tree_metadata"]),
            "keys": store.keys(),
            "zarray": {k: store.get(k) for k in store.keys()
                       if k.endswith(b"/.zarray")}}


# -- 1. every optimizer's train state -----------------------------------------

@pytest.mark.parametrize("alg,scheduled,mom", COMBOS)
def test_jax_restores_every_optimizer_combination(tmp_path, alg, scheduled,
                                                  mom):
    """A train state after one update, written by the port's
    ``Checkpointer``: the JAX package's ``load_variables(path, template)``
    and ``Checkpointer.restore(template=...)`` give its tree back, leaf
    for leaf bit-exact with JAX's dtypes, and ``checkpoint_keys`` calls
    it a full train state."""
    jcfg = jax_orbax_config(alg, _flags(scheduled, mom))
    _, state, _, _ = jax_orbax_state(jcfg, _twin(), grads_seed=3)
    state = jax.device_get(state)
    saved = ckpt.Checkpointer(str(tmp_path), alg=alg, scheduled=scheduled,
                              mom=mom).save(1, _port_state(state))
    assert saved == str(tmp_path / "nhans" / "1")
    template = _abstract(state)
    _same_tree(jckpt.load_variables(saved, template), state, "load_variables")
    jck = jckpt.Checkpointer(str(tmp_path))
    try:
        step, restored = jck.restore(template=template)
    finally:
        jck.close()
    assert step == 1
    _same_tree(restored, state, "Checkpointer.restore")
    keys = frozenset({"params", "batch_stats", "opt_state", "step"})
    assert jckpt.checkpoint_keys(saved) == ckpt.checkpoint_keys(saved) == keys


# -- 2. the files against the JAX package's -----------------------------------

@pytest.mark.parametrize("tree", ["variables", "adam", "adam_cosine",
                                  "rmsprop_cosine_mom", "sgd"])
def test_files_equal_what_jax_writes(tmp_path, tree):
    """The same tree written by both packages: equal ``_METADATA`` (its
    ``tree_metadata`` in the same order, empty optax nodes as JAX records
    them), equal store keys and byte-equal ``.zarray`` files, and the
    same ``_CHECKPOINT_METADATA`` fields and layout."""
    variables = _twin()
    if tree == "variables":
        jckpt.save_variables(str(tmp_path / "jax"), variables)
        ckpt.save_variables(str(tmp_path / "port"),
                            {k: v for k, v in _flat(variables).items()})
        dirs = {who: tmp_path / who for who in ("jax", "port")}
        trees = dirs
    else:
        alg, *opts = tree.split("_")
        scheduled, mom = "cosine" in opts, 0.9 if "mom" in opts else 0.0
        _, state, _, _ = jax_orbax_state(
            jax_orbax_config(alg, _flags(scheduled, mom)), variables,
            grads_seed=2)
        state = jax.device_get(state)
        _save_state(tmp_path / "jax", 1, state)
        ckpt.Checkpointer(str(tmp_path / "port"), alg=alg,
                          scheduled=scheduled, mom=mom).save(
            1, _port_state(state))
        dirs = {who: tmp_path / who / "nhans" / "1"
                for who in ("jax", "port")}
        trees = {who: d / "default" for who, d in dirs.items()}
    jax_files, port_files = (_tree_files(str(trees[w]))
                             for w in ("jax", "port"))
    assert port_files["meta"] == jax_files["meta"]
    assert port_files["order"] == jax_files["order"]
    if tree.startswith("adam") and "cosine" not in tree:
        assert jax_files["meta"]["tree_metadata"]["('opt_state', '1')"][
            "value_metadata"] == {"value_type": "None",
                                  "skip_deserialize": True}
    assert port_files["keys"] == jax_files["keys"]
    assert port_files["zarray"] == jax_files["zarray"]
    metas = {}
    for who, d in dirs.items():
        with open(d / orbax.CHECKPOINT_METADATA) as f:
            metas[who] = json.load(f)
    assert sorted(metas["port"]) == sorted(metas["jax"])
    assert metas["port"]["item_handlers"] == metas["jax"]["item_handlers"]
    assert sorted(os.listdir(dirs["port"])) == sorted(
        n for n in os.listdir(dirs["jax"]) if n != "ocdbt.process_0")


# -- 3. full width, with JAX blocked while writing ----------------------------

def test_full_width_weights_written_with_jax_blocked_restore_in_jax(
        tmp_path):
    """``tools/ckpt_npz unpack`` of the shipped denoiser weights in a
    process where jax, orbax, tensorstore and nhans_tpu cannot be
    imported; the JAX package's ``load_variables`` reads the directory
    back bit-exactly, with and without a template."""
    out = str(tmp_path / "q5")
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'orbax', 'tensorstore',"
            " 'nhans_tpu'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['ckpt_npz', 'unpack', sys.argv[1], sys.argv[2]]\n"
            "runpy.run_module('nhans_tpu_torch.tools.ckpt_npz',"
            " run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code, DENOISER_NPZ, out],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "unpacked 571 tensors" in r.stdout
    want = jax_variables(DENOISER_NPZ)
    _same_tree(jckpt.load_variables(out), want, "raw")
    _same_tree(jckpt.load_variables(out, _abstract(want)), want, "template")
    assert jckpt.checkpoint_keys(out) == {"params", "batch_stats"}


# -- 4. JAX -> port -> JAX ----------------------------------------------------

def test_committed_fixtures_round_trip_through_the_port(tmp_path):
    """The committed fixtures read by the port and written again restore
    in JAX equal to the originals: the variables directory, and the Adam
    run's train state (cosine lr, so a schedule count)."""
    ckpt.save_variables(str(tmp_path / "vars"),
                        orbax.read(FIXTURES["variables"]))
    _same_tree(jckpt.load_variables(str(tmp_path / "vars")),
               jckpt.load_variables(FIXTURES["variables"]), "variables")

    variables, extra = ckpt.load(FIXTURES["run"], alg="adam")
    stats = {k: v for k, v in variables.items()
             if k.startswith("batch_stats/")}
    state = TrainState(
        step=int(extra["step"]),
        params=from_flax({k: v for k, v in variables.items()
                          if k not in stats}),
        batch_stats=from_flax(stats),
        opt_state=ckpt.opt_state_from_flat(extra, "cpu"))
    ckpt.Checkpointer(str(tmp_path / "run"), alg="adam", scheduled=True,
                      mom=0.9).save(1, state)
    template = _abstract(jax_orbax_state(jax_orbax_config("adam"),
                                         _twin())[1])
    got, want = (jckpt.Checkpointer(root) for root in
                 (str(tmp_path / "run"), FIXTURES["run"]))
    try:
        _same_tree(got.restore(template=template)[1],
                   want.restore(template=template)[1], "train state")
    finally:
        got.close()
        want.close()


# -- 5. resuming across the packages ------------------------------------------

def _jax_trainer(jcfg, workdir, checkpoint_dir, restore_path=""):
    from nhans_tpu.train.trainer import Trainer as JaxTrainer

    cfg = jcfg.replace(
        data=dataclasses.replace(jcfg.data, device_corpus="off"),
        train=dataclasses.replace(
            jcfg.train, checkpoint_dir=str(checkpoint_dir),
            restore_path=str(restore_path),
            summaries_dir=str(workdir / "sum")))
    return JaxTrainer(cfg, eval_utts=0)


def _port_step_then_save(tmp_path):
    """The port's trainer resumed from the committed JAX run (step 1),
    one Adam step on the committed golden's inputs and draws, and
    ``save_and_eval``: the trainer, its run root holding step 2."""
    trainer = port_orbax_trainer(FIXTURES["run"], "adam", "cpu",
                                 str(tmp_path / "port"))
    with np.load(FIXTURES["golden"]) as z:
        golden = {k: z[k] for k in z.files}
    port_orbax_step(trainer, golden)
    trainer.tstep = trainer.state.step
    assert trainer.tstep == 2
    trainer.save_and_eval()
    return trainer, tmp_path / "port" / "ck"


def _port_flat(trainer) -> dict:
    """The port trainer's state as the JAX ``TrainState`` flattens it."""
    flat = ckpt.orbax_train_state(trainer._full_state(), trainer.ckpt.chain)
    return {k: v for k, v in flat.items() if v is not None}


def test_jax_trainer_resumes_a_port_run(tmp_path):
    """The JAX ``Trainer`` with ``--restore_path`` and by auto-resume
    takes the port's step 2 bit-exactly, and its next step is the port's
    next step (the port's trainer auto-resumed from its own step) within
    phase 8's bars."""
    port, root = _port_step_then_save(tmp_path)
    jcfg = jax_orbax_config("adam")
    restored = _jax_trainer(jcfg, tmp_path / "a", tmp_path / "a" / "ck",
                            restore_path=root)
    resumed = _jax_trainer(jcfg, tmp_path / "b", root)
    want = _port_flat(port)
    for jt in (restored, resumed):
        assert jt.tstep == 2
        _exact(_flat(jax.device_get(jt.state)), want, "JAX trainer")
    golden = jax_next_step(jcfg, restored.model, restored.tx,
                           restored.state, ORBAX_SEED + 2)
    again = port_orbax_trainer("", "adam", "cpu", str(tmp_path / "port"))
    assert again.tstep == 2 and again.state.opt_state["count"] == 2
    _within_phase8_bars(port_orbax_step(again, golden), golden)


def test_port_resumes_its_own_orbax_step(tmp_path):
    """A fresh port trainer on the run root auto-resumes the step the port
    wrote: the step, the update count and every array exactly."""
    port, root = _port_step_then_save(tmp_path)
    assert sorted(os.listdir(root / "nhans")) == ["2"]
    again = port_orbax_trainer("", "adam", "cpu", str(tmp_path / "port"))
    assert again.tstep == 2 and again.state.opt_state["count"] == 2
    _exact(_port_flat(again), _port_flat(port), "resumed")


def _npz_step(root, step: int, state, alg: str) -> None:
    """A step directory as earlier versions of the port wrote it:
    ``variables.npz`` and ``train_state.npz``."""
    d = os.path.join(root, str(step))
    os.makedirs(d)
    np.savez(os.path.join(d, ckpt.VARIABLES),
             **to_flax(state.params, "params"),
             **to_flax(state.batch_stats, "batch_stats"))
    extra = {"step": np.int64(step), "alg": np.array(alg),
             "opt/count": np.int64(state.opt_state["count"])}
    for slot, tensors in state.opt_state.items():
        if slot != "count":
            extra.update(to_flax(tensors, f"opt/{slot}"))
    np.savez(os.path.join(d, ckpt.TRAIN_STATE), **extra)


def test_mixed_root_resumes_from_its_latest_step(tmp_path):
    """A run root holding ``.npz`` steps of an earlier port and the port's
    Orbax steps: auto-resume takes the latest step of either form, and
    ``train_supervisor.latest_step`` and keep-K count both."""
    port, root = _port_step_then_save(tmp_path)
    run = str(root / "nhans")
    state = port._full_state()
    _npz_step(run, 1, state, "adam")
    assert ckpt.list_steps(run) == [1, 2]
    again = port_orbax_trainer("", "adam", "cpu", str(tmp_path / "port"))
    assert again.tstep == 2 and not os.path.exists(
        os.path.join(run, "2", ckpt.VARIABLES))
    _exact(_port_flat(again), _port_flat(port), "Orbax step 2")

    _npz_step(run, 3, dataclasses.replace(
        state, step=3, opt_state={**state.opt_state, "count": 3}), "adam")
    assert train_supervisor.latest_step(str(root)) == 3
    newest = port_orbax_trainer("", "adam", "cpu", str(tmp_path / "port"))
    assert newest.tstep == 3 and newest.state.opt_state["count"] == 3
    want = {k: v for k, v in _port_flat(port).items()
            if not k.endswith("count") and k != "step"}
    got = {k: v for k, v in _port_flat(newest).items() if k in want}
    _exact(got, want, ".npz step 3")
    newest.ckpt.max_to_keep = 2
    newest.tstep = newest.state.step = 4
    newest.save_and_eval()
    assert ckpt.list_steps(run) == [3, 4]


def test_supervisor_counts_orbax_steps(tmp_path):
    """``train_supervisor.latest_step`` on run roots of Orbax steps only,
    written by the port and by the JAX package."""
    _, state, _, _ = jax_orbax_state(jax_orbax_config("sgd"), _twin(),
                                     grads_seed=1)
    state = jax.device_get(state)
    _save_state(tmp_path / "jax", 4, state)
    ck = ckpt.Checkpointer(str(tmp_path / "port"))
    for step in (3, 7):
        ck.save(step, _port_state(state))
    (tmp_path / "port" / "nhans" / "9.tmp-1" / "default").mkdir(parents=True)
    assert train_supervisor.latest_step(str(tmp_path / "jax")) == 4
    assert train_supervisor.latest_step(str(tmp_path / "port")) == 7
    assert ck.steps() == [3, 7]


# -- 6. the pieces: chunking, the store, zstd ---------------------------------

@pytest.mark.parametrize("shape,itemsize,target", [
    ((13312, 201), 4, 1 << 31), ((0, 5), 4, 1 << 31), ((), 4, 1 << 31),
    ((12, 10), 4, 64), ((4, 4, 512, 512), 4, 1 << 20), ((7, 3), 8, 8),
    ((6, 35, 9), 4, 500)])
def test_chunk_shape_is_orbax_choice(shape, itemsize, target):
    """``chunk_shape`` against orbax's own ``choose_chunk_shape`` for an
    array written whole by one process."""
    from orbax.checkpoint._src.arrays import subchunking
    from orbax.checkpoint._src.serialization.tensorstore_utils import \
        calculate_chunk_byte_size

    dtype = np.dtype(f"<f{itemsize}")
    size = calculate_chunk_byte_size(shape, dtype, chunk_byte_size=None,
                                     ocdbt_target_data_file_size=target)
    want = subchunking.choose_chunk_shape(shape, shape, dtype, size)
    assert orbax.chunk_shape(shape, itemsize, target) == tuple(want)


def test_store_reads_in_tensorstore(tmp_path):
    """A store of inline values (up to 1024 bytes, the empty one too) and
    values in the data file, under keys that share prefixes: tensorstore's
    ocdbt driver lists and reads exactly what was written, and so does
    the port's reader."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(5)
    values = {b"": b"root", b"a": b"", b"params.w/.zarray": b"{}" * 40}
    for i in range(60):
        n = int(rng.choice([0, 17, 1024, 1025, 5000]))
        values[f"params.block{i % 7}.w{i}/{i}.0".encode()] = rng.integers(
            0, 256, n, np.uint8).tobytes()
    orbax.write_store(str(tmp_path), values)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/"}).result()
    assert sorted(kv.list().result()) == sorted(values)
    store = orbax.OcdbtStore(str(tmp_path))
    assert store.keys() == sorted(values)
    assert store.indirect == sum(len(v) > 1024 for v in values.values())
    for key, value in values.items():
        assert kv.read(key).result().value == value, key
        assert store.get(key) == value, key


def test_zstd_compress_round_trips():
    rng = np.random.default_rng(6)
    for data in (b"", rng.integers(0, 4, 100_000, np.uint8).tobytes()):
        for level in (0, 1, 19):
            packed = zstd.compress(data, level)
            assert zstd.decompress(packed, size=len(data)) == data
    assert len(zstd.compress(bytes(1 << 20), 1)) < 1000


def test_writer_refuses_dtypes_jax_does_not_save(tmp_path):
    with pytest.raises(ValueError, match="float16"):
        orbax.write(str(tmp_path / "t"),
                    {"params/w": np.zeros(3, np.float16)})


def test_save_refuses_a_state_of_another_optimizer(tmp_path):
    """A ``Checkpointer`` of an Adam run handed an sgd state names both
    and writes no step."""
    _, state, _, _ = jax_orbax_state(jax_orbax_config("sgd"), _twin(),
                                     grads_seed=1)
    ck = ckpt.Checkpointer(str(tmp_path), alg="adam", scheduled=True)
    with pytest.raises(ValueError, match=r"slots \['count'\] do not fit"):
        ck.save(1, _port_state(jax.device_get(state)))
    assert ck.steps() == []
