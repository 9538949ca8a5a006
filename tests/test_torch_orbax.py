"""The port reads the JAX package's Orbax checkpoints with its own reader
(``nhans_tpu_torch/compat/orbax.py``, ``train/checkpoint.py``), against the
JAX package, orbax and tensorstore on the CPU.

The JAX side writes in ``tmp_path`` with the JAX package's own
``save_variables`` and ``Checkpointer``, at the narrow widths of the
committed fixtures (``tests/make_torch_golden.py``: ``ORBAX_MODEL``, the
full-width model's 571 names) and, for the shipped weights, at full
width.  Reads are exact; a resumed step is held to the JAX package's next
step with the bars of ``chip_smoke.py``'s phase 8 (loss 1e-4 relative,
each recorded update within 1e-3 of its largest |delta|, BatchNorm
statistics 1e-4 + 1e-3 relative)."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import wavfile

from nhans_tpu.train import checkpoint as jckpt
from nhans_tpu_torch.cli import _app
from nhans_tpu_torch.cli import train as cli_train
from nhans_tpu_torch.compat import orbax
from nhans_tpu_torch.compat.weights import from_flax, to_flax
from nhans_tpu_torch.tools import ckpt_average, ckpt_npz
from nhans_tpu_torch.train import checkpoint as ckpt
from nhans_tpu_torch.train.optim import make_optimizer, make_schedule
from tests.make_torch_golden import (DENOISER_NPZ, TRAIN_LAYERS, TRAIN_STATS,
                                     jax_orbax_config, jax_orbax_fixtures,
                                     jax_orbax_state, jax_variables,
                                     orbax_paths, port_orbax_step,
                                     port_orbax_trainer, train_gap)

FIXTURES = orbax_paths()
ALGS = ("sgd", "momentum", "rmsprop", "adadelta", "adagrad", "adam")
# phase 8's bars
LOSS_RTOL = 1e-4
DELTA_RTOL = 1e-3
STATS_ATOL, STATS_RTOL = 1e-4, 1e-3
# the committed fixtures against what the target writes on this CPU: the
# variables exactly, what a training step made within float32 rounding
FIXTURE_RTOL = 1e-5


def _flat(tree) -> dict:
    """A JAX tree as ``/``-joined paths -> numpy arrays."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(k, "key", getattr(k, "idx",
                                               getattr(k, "name", k))))
                 for k in path]
        out["/".join(names)] = np.asarray(x)
    return out


def _twin() -> dict:
    return jax_variables(FIXTURES["npz"])


def _exact(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), \
            f"{what}: {k}"


def _save_state(root, step, state) -> None:
    ck = jckpt.Checkpointer(str(root))
    ck.save(step, jax.device_get(state))
    ck.wait()
    ck.close()


def _within_phase8_bars(got: dict, want: dict) -> None:
    gap = train_gap(want, got, "gap")
    assert gap["gap/loss"] <= LOSS_RTOL, gap
    for path in TRAIN_LAYERS:
        assert gap[f"gap/delta/{path}"] <= DELTA_RTOL, (path, gap)
    for path in TRAIN_STATS:
        for name in ("pop_mean", "pop_variance"):
            key = f"stats/{path}/{name}"
            np.testing.assert_allclose(got[key], want[key], atol=STATS_ATOL,
                                       rtol=STATS_RTOL, err_msg=key)


@pytest.fixture(scope="module")
def jax_adam(tmp_path_factory):
    """``tests/make_torch_golden.py orbax`` run into a temporary directory:
    (its fixture paths, its golden)."""
    root = str(tmp_path_factory.mktemp("orbax_target"))
    return orbax_paths(root), jax_orbax_fixtures(root)


# -- 1. every form ------------------------------------------------------------

def test_every_orbax_form_reads_back_exactly(tmp_path):
    """A variables directory, a step directory (and its ``default``), a
    run root and ``<ckdir>/nhans`` (the latest of two steps): the port's
    keys and variables are the JAX package's ``checkpoint_keys`` and
    ``load_variables`` flattened, and a train state's step is the
    latest."""
    jcfg = jax_orbax_config("adam")
    variables = _twin()
    jckpt.save_variables(str(tmp_path / "vars"), variables)
    for step, seed in ((1, 1), (2, 2)):
        _save_state(tmp_path / "ck", step,
                    jax_orbax_state(jcfg, variables, grads_seed=seed)[1])
    run = tmp_path / "ck" / "nhans"
    forms = {tmp_path / "vars": False, run / "2": True,
             run / "2" / "default": True, tmp_path / "ck": True, run: True}
    for form, full in forms.items():
        form = str(form)
        keys = jckpt.checkpoint_keys(form)
        assert ckpt.checkpoint_keys(form) == keys, form
        assert ({"opt_state", "step"} <= keys) == full, form
        raw = _flat(jckpt.load_variables(form))
        want = {k: v for k, v in raw.items()
                if k.split("/")[0] in ("params", "batch_stats")}
        _exact(ckpt.load_variables(form), want, form)
        loaded, extra = ckpt.load(form, alg="adam")
        _exact(loaded, want, form)
        assert (extra is not None) == full, form
        if full:
            assert int(extra["step"]) == int(raw["step"]) == int(
                extra["opt/count"]) == int(raw["opt_state/0/count"])
    # the two steps differ, and the run root read the latest
    assert not np.array_equal(
        ckpt.load_variables(str(run / "1"))["params/last_dense/b"],
        ckpt.load_variables(str(run))["params/last_dense/b"])
    assert ckpt.list_steps(str(run)) == [1, 2]


def test_checkpoint_tools_take_orbax_directories(tmp_path):
    """``tools/ckpt_average`` over two steps of a JAX run root and
    ``tools/ckpt_npz pack`` of a JAX variables directory, as they take
    the port's forms: the float64 mean, and the shipped file's dtypes."""
    jcfg = jax_orbax_config("momentum")
    variables = _twin()
    jckpt.save_variables(str(tmp_path / "vars"), variables)
    for step in (1, 2):
        _save_state(tmp_path / "ck", step,
                    jax_orbax_state(jcfg, variables, grads_seed=step)[1])
    run = str(tmp_path / "ck" / "nhans")
    ckpt_average.main(["--checkpoint_root", run, "--steps", "1,2",
                       "--out", str(tmp_path / "avg")])
    steps = [ckpt.load_variables(os.path.join(run, s)) for s in "12"]
    avg = ckpt.load_variables(str(tmp_path / "avg"))
    assert sorted(avg) == sorted(steps[0])
    for k, v in avg.items():
        want = (steps[0][k].astype(np.float64) + steps[1][k]) / 2
        assert np.array_equal(v, want.astype(np.float32)), k
    packed = ckpt_npz.pack(str(tmp_path / "vars"), str(tmp_path / "p.npz"))
    flat = ckpt.load_variables(str(tmp_path / "vars"))
    assert sorted(packed) == sorted(flat)
    for k, v in flat.items():
        want = v if k.startswith("batch_stats/") else v.astype(np.float16)
        assert packed[k].dtype == want.dtype and np.array_equal(
            packed[k], want), k


# -- 2. the key-value store against tensorstore -------------------------------

def test_ocdbt_listing_matches_tensorstore(tmp_path):
    """Keys and values of a store with a B-tree of more than one level,
    values both inline and in data files, several commits and data files
    (tensorstore's ocdbt key-value store with small nodes), and of the
    committed fixtures' merged and per-process stores."""
    ts = pytest.importorskip("tensorstore")
    root = str(tmp_path / "deep")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 64,
                                     "version_tree_arity_log2": 1}}).result()
    rng = np.random.default_rng(7)
    for _ in range(12):
        with ts.Transaction() as txn:
            for _ in range(8):
                key = (f"params.block{rng.integers(0, 9)}.w/"
                       f"{rng.integers(0, 400)}.{'0' * rng.integers(0, 12)}")
                kv.with_transaction(txn)[key] = rng.integers(
                    0, 256, int(rng.integers(0, 200)), np.uint8).tobytes()
    roots = [root]
    for name in ("variables", "run"):
        tree = FIXTURES[name] if name == "variables" else os.path.join(
            FIXTURES["run"], "nhans", "1", "default")
        roots += [tree, os.path.join(tree, "ocdbt.process_0")]
    for path in roots:
        store = orbax.OcdbtStore(path)
        ref = ts.KvStore.open({"driver": "ocdbt",
                               "base": f"file://{path}/"}).result()
        keys = sorted(ref.list().result())
        assert store.keys() == keys, path
        for key in keys:
            assert store.get(key) == ref.read(key).result().value, key
        assert store.get(b"absent") is None
    deep = orbax.OcdbtStore(root)
    assert deep.heights[0] > 1
    assert 0 < deep.indirect < len(deep.keys())


def _zarr_tree(ts, root: str, use_ocdbt: bool, compressor=None) -> dict:
    """Arrays written by tensorstore's zarr support under ``root`` as
    an Orbax tree names them, with a hand-written ``_METADATA``: a float
    array cut into a grid of chunks with one never written (read as its
    fill value), an int64 vector with a null fill value and an int32
    scalar.  Returns what each holds."""
    base = ({"driver": "ocdbt", "base": f"file://{root}/"} if use_ocdbt
            else f"file://{root}/")
    comp = compressor or {"id": "zstd", "level": 3}
    specs = {
        ("params", "w"): ([5, 7], [2, 3], "<f4", 1.5),
        ("params", "v"): ([4], [4], "<i8", None),
        ("step",): ([], [], "<i4", None),
    }
    want, leaves = {}, {}
    for path, (shape, chunks, dtype, fill) in specs.items():
        name = ".".join(path)
        arr = ts.open({"driver": "zarr", "kvstore": base, "path": name,
                       "metadata": {"shape": shape, "chunks": chunks,
                                    "dtype": dtype, "fill_value": fill,
                                    "compressor": comp}},
                      create=True).result()
        value = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
        if path == ("params", "w"):
            value = value.astype(np.float32) * 0.25 - 3.0
            arr[:4, :].write(value[:4]).result()
            value[4:] = 1.5  # the last row of chunks is never written
        else:
            arr.write(value).result()
        want["/".join(path)] = value
        leaves[str(path)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in path],
            "value_metadata": {"value_type": "np.ndarray"}}
    leaves["('opt_state', '0')"] = {
        "key_metadata": [{"key": "opt_state", "key_type": 2},
                         {"key": "0", "key_type": 1}],
        "value_metadata": {"value_type": "None"}}
    with open(os.path.join(root, orbax.METADATA), "w") as f:
        json.dump({"tree_metadata": leaves, "use_ocdbt": use_ocdbt,
                   "use_zarr3": False}, f)
    return want


@pytest.mark.parametrize("use_ocdbt", [True, False])
def test_zarr_chunk_grid_fill_and_layouts(tmp_path, use_ocdbt):
    """Chunks smaller than the array, a missing chunk read as the fill
    value, int64 and int32 scalars, an empty node, and both the OCDBT
    layout and the older one of a directory per array."""
    ts = pytest.importorskip("tensorstore")
    root = str(tmp_path / "tree")
    os.makedirs(root)
    want = _zarr_tree(ts, root, use_ocdbt)
    got = orbax.read(root)
    _exact(got, want, root)
    assert orbax.top_level_keys(root) == {"params", "step", "opt_state"}
    assert sorted(orbax.read(root, keep=("step",))) == ["step"]


# -- 3. full width ------------------------------------------------------------

def test_full_width_shipped_weights_read_and_serve_exactly(tmp_path):
    """The shipped denoiser weights written by the JAX package read back
    bit-exact, and the serving command line on a seeded 0.6 s utterance
    gives the same wavs from the directory as from the ``.npz``."""
    jckpt.save_variables(str(tmp_path / "q5"),
                         jax.tree_util.tree_map(jnp.asarray,
                                                jax_variables(DENOISER_NPZ)))
    with np.load(DENOISER_NPZ) as z:
        want = {k: z[k].astype(np.float32) for k in z.files}
    _exact(ckpt.load_variables(str(tmp_path / "q5")), want, "full width")

    rng = np.random.default_rng(13)
    t = np.arange(9600) / 16000.0
    wavs = {"in": 5000 * np.sin(2 * np.pi * 220 * t)
            + rng.standard_normal(len(t)) * 1500,
            "neg": rng.standard_normal(20000) * 1500}
    for name, x in wavs.items():
        wavfile.write(str(tmp_path / f"{name}.wav"), 16000,
                      np.rint(x).astype(np.int16))
    outs = {}
    for tag, checkpoint in (("orbax", tmp_path / "q5"),
                            ("npz", DENOISER_NPZ)):
        (tmp_path / tag).mkdir()
        _app.run("denoiser", [
            "--device", "cpu", "--checkpoint", str(checkpoint), "--input",
            str(tmp_path / "in.wav"), "--neg", str(tmp_path / "neg.wav"),
            "--pos", "", "--output", str(tmp_path / tag / "out.wav")])
        outs[tag] = {f: wavfile.read(str(tmp_path / tag / f))[1]
                     for f in sorted(os.listdir(tmp_path / tag))}
    assert sorted(outs["orbax"]) == sorted(outs["npz"]) and len(
        outs["npz"]) == 4
    for f, x in outs["npz"].items():
        assert np.array_equal(outs["orbax"][f], x), f


# -- 4. the optimizer slots of every --alg ------------------------------------

@pytest.mark.parametrize("alg", ALGS)
def test_optax_slots_map_exactly(tmp_path, alg):
    """A JAX train state after one optimizer update: the port's
    ``opt/<slot>/<path>`` are optax's leaves exactly (``OPTAX_SLOTS``),
    its count and step are the update count, and the port's optimizer
    continues from them as optax does."""
    jcfg = jax_orbax_config(alg)
    _, state, tx, _ = jax_orbax_state(jcfg, _twin(), grads_seed=3)
    _save_state(tmp_path, 1, state)
    _, extra = ckpt.load(str(tmp_path), alg=alg)
    assert int(extra["step"]) == 1 and int(extra["opt/count"]) == 1
    want = {k: v for k, v in _flat(state.opt_state).items()
            if not k.endswith("count")}
    slots = ckpt.OPTAX_SLOTS[alg]
    got = {k: v for k, v in extra.items()
           if k.startswith("opt/") and k != "opt/count"}
    assert len(got) == len(want)
    for key, value in want.items():
        index, field, path = key.split("/", 2)
        mine = got[f"opt/{slots[f'{index}/{field}']}/{path}"]
        assert mine.dtype == value.dtype and np.array_equal(mine, value), key

    t = jcfg.train
    port_tx = make_optimizer(alg, make_schedule(
        t.lr, t.lr_schedule, t.lr_decay_steps, t.lr_min_frac), t.mom)
    opt = ckpt.opt_state_from_flat(extra, "cpu")
    g = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda x: (1e-2 * g.standard_normal(x.shape)).astype(np.float32),
        state.params)
    jupd, _ = tx.update(grads, state.opt_state, state.params)
    upd, new = port_tx.update(
        from_flax({f"params/{k}": v for k, v in _flat(grads).items()}), opt)
    assert new["count"] == 2
    mine = to_flax(upd, "params")
    for key, value in _flat(jupd).items():
        np.testing.assert_allclose(mine[f"params/{key}"], value,
                                   rtol=1e-5, atol=1e-7, err_msg=key)


# -- 5. the next step after --restore_path ------------------------------------

@pytest.mark.parametrize("alg", ["adam", "momentum"])
def test_resumed_step_matches_jax_next_step(tmp_path, alg, jax_adam):
    """``cli.train --restore_path <JAX run root> --alg`` (its Trainer, the
    model narrowed) continues at JAX's step with JAX's slots, and its next
    step is the JAX package's within phase 8's bars."""
    if alg == "adam":
        paths, golden = jax_adam
    else:
        (tmp_path / "jax").mkdir()
        paths = orbax_paths(str(tmp_path / "jax"))
        golden = jax_orbax_fixtures(str(tmp_path / "jax"), alg,
                                    variables=_twin())
    trainer = port_orbax_trainer(paths["run"], alg, "cpu",
                                 str(tmp_path / "port"))
    assert trainer.tstep == int(golden["step"]) == 1
    assert trainer.state.opt_state["count"] == 1
    _within_phase8_bars(port_orbax_step(trainer, golden), golden)


# -- 6. refusals --------------------------------------------------------------

@pytest.mark.parametrize("alg,needle", [
    ("sgd", "opt_state/0/mu does not fit --alg sgd"),
    ("rmsprop", "opt_state/0/mu does not fit --alg rmsprop"),
])
def test_alg_mismatch_names_both(tmp_path, alg, needle):
    """The Adam fixture resumed with another --alg: the command line exits
    with a message naming the optax field and the run's --alg."""
    with pytest.raises(SystemExit) as err:
        cli_train.build_trainer([
            "--device", "cpu", "--restore_path", FIXTURES["run"], "--alg",
            alg, "--device_corpus", "off", "--eval_utts", "0",
            "--checkpoint_dir", str(tmp_path / "ck"),
            "--summaries_dir", str(tmp_path / "sum")])
    assert needle in str(err.value.code)


def test_missing_slots_name_both(tmp_path):
    """An sgd train state (no arrays under opt_state) resumed with
    --alg adam: the trainer names the slots of both."""
    _, state, _, _ = jax_orbax_state(jax_orbax_config("sgd"), _twin(),
                                     grads_seed=5)
    _save_state(tmp_path / "sgd", 1, state)
    with pytest.raises(ValueError, match=r"slots \['count'\] do not fit "
                       r"--alg adam .*\['count', 'mu', 'nu'\]"):
        port_orbax_trainer(str(tmp_path / "sgd"), "adam", "cpu",
                           str(tmp_path / "port"))


def _copy_variables(tmp_path) -> str:
    dst = str(tmp_path / "vars")
    shutil.copytree(FIXTURES["variables"], dst)
    return dst


def _largest_data_file(root: str) -> str:
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if os.path.basename(d) == "d"]
    return max(files, key=os.path.getsize)


@pytest.mark.parametrize("case", ["truncated", "corrupt_node", "zarr3",
                                  "compressor"])
def test_refusals_name_the_file_or_field(tmp_path, case):
    """A truncated data file and a corrupt B-tree node name the file;
    ``use_zarr3`` and an unknown compressor name the field.  None of them
    reads as zeros."""
    if case == "compressor":
        ts = pytest.importorskip("tensorstore")
        root = str(tmp_path / "tree")
        os.makedirs(root)
        _zarr_tree(ts, root, True, {"id": "blosc", "cname": "lz4"})
        needle = "unknown compressor"
    else:
        root = _copy_variables(tmp_path)
    if case == "truncated":
        path = _largest_data_file(root)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        needle = path
    elif case == "corrupt_node":
        path = os.path.join(root, "d", os.listdir(os.path.join(root, "d"))[0])
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
        needle = path
    elif case == "zarr3":
        meta_path = os.path.join(root, orbax.METADATA)
        meta = json.load(open(meta_path))
        meta["use_zarr3"] = True
        json.dump(meta, open(meta_path, "w"))
        needle = "use_zarr3"
    with pytest.raises(ValueError) as err:
        ckpt.load_variables(root)
    assert needle in str(err.value)


# -- 7. the committed fixtures ------------------------------------------------

def test_committed_fixtures_equal_the_target(jax_adam):
    """What ``tests/make_torch_golden.py orbax`` writes now: the variables
    and their twin exactly, the run's state and the next step's golden
    within float32 rounding of a training step."""
    paths, golden = jax_adam
    _exact(orbax.read(FIXTURES["variables"]), orbax.read(paths["variables"]),
           "variables")
    with np.load(FIXTURES["npz"]) as a, np.load(paths["npz"]) as b:
        _exact({k: a[k] for k in a.files}, {k: b[k] for k in b.files}, "npz")
    mine = orbax.read(os.path.join(FIXTURES["run"], "nhans", "1", "default"))
    theirs = orbax.read(os.path.join(paths["run"], "nhans", "1", "default"))
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(mine[k], v, rtol=FIXTURE_RTOL,
                                   atol=FIXTURE_RTOL * np.abs(v).max(),
                                   err_msg=k)
    with np.load(FIXTURES["golden"]) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(committed) == sorted(golden)
    for k, v in golden.items():
        if v.dtype.kind in "US":
            assert str(committed[k]) == str(v), k
        else:
            np.testing.assert_allclose(committed[k], v, rtol=FIXTURE_RTOL,
                                       atol=FIXTURE_RTOL * np.abs(v).max(),
                                       err_msg=k)

