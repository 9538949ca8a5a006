"""The port's TF-checkpoint importer (nhans_tpu_torch.compat) against the
JAX package's (nhans_tpu.compat) on synthetic bundles.

A bundle holds every name of the task's map (571, and the separator's
unused ``Variable``) with random values, TF-shaped biases ([1, 1, 1, C])
and BatchNorm tensors, at narrow channel widths: the name map does not
depend on width.  Both importers read it; the port's flat variables must
equal the JAX tree after ``from_flax`` tensor for tensor, and a forward
pass on them must match the JAX model's within 1e-5 of its scale.  A
conv kernel reshaped straight into the port's OIHW shape (the silent bug
a by-count reshape invites) must fail the same checks.  The checks
against the reference's real ``.index`` files skip where those files are
absent, as tests/test_tf_compat.py's do."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nhans_tpu.compat.tf_import import import_tf_checkpoint as j_import
from nhans_tpu.compat.tf_import import tf_name_map as j_name_map
from nhans_tpu.config import Config as JConfig
from nhans_tpu.models import init_variables as j_init
from nhans_tpu_torch.compat import TFBundleReader, import_tf_checkpoint
from nhans_tpu_torch.compat import tf_import as port
from nhans_tpu_torch.compat.tf_bundle import write_bundle
from nhans_tpu_torch.compat.weights import from_flax
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.nn.model import NHANSNet
from tests.test_tf_compat import REF_SN, REF_SS, needs_ref

# every block of the published tower, at narrow widths: blocks 1, 3, 5
# and 7 change channels and so keep their shortcut conv
NARROW = dict(
    embedding_dim=16, pos_embed_hidden=6,
    main_blocks=((4, 1, 4), (4, 1, 4), (4, 2, 6), (4, 1, 6),
                 (3, 2, 8), (3, 1, 8), (3, 2, 10), (3, 1, 10)),
    context_blocks=(((8, 4), (3, 2), 4), ((8, 4), (3, 2), 6),
                    ((4, 4), (1, 1), 8), ((4, 4), (1, 2), 10)))
# forward pass of the imported weights: max |diff| over (max |ref| + 1)
FORWARD_BAR = 1e-5


def _configs(task):
    jcfg = getattr(JConfig, task)()
    tcfg = getattr(Config, task)()
    return (jcfg.replace(model=dataclasses.replace(jcfg.model, **NARROW)),
            tcfg.replace(model=dataclasses.replace(tcfg.model, **NARROW)))


def _tf_shape(shape):
    """A TF tensor's shape for a flax shape: vectors (biases, BatchNorm
    tensors) are stored [1, 1, 1, C]."""
    return (1, 1, 1) + tuple(shape) if len(shape) == 1 else tuple(shape)


def synthetic_bundle(prefix, cfg, task, seed=0, skip=(), resize=()):
    """Write a bundle of every mapped name (plus the separator's
    ``Variable``) with seeded random values; returns {tf name: array}.
    Names in ``skip`` are left out, names in ``resize`` get one element
    too many."""
    rng = np.random.default_rng(seed)
    shapes = port.flax_shapes(cfg)
    tensors = {}
    for tf_name, (coll, path) in port.tf_name_map(task).items():
        if tf_name in skip:
            continue
        shape = _tf_shape(shapes[port.flax_key(coll, path)])
        if tf_name in resize:
            shape = shape[:-1] + (shape[-1] + 1,)
        # kernels at 1 / sqrt(fan in), so that every layer reaches the
        # output at its own scale; vectors at 0.05
        std = (1 / np.sqrt(np.prod(shape[:-1])) if tf_name.endswith("/w")
               else 0.05)
        arr = (rng.standard_normal(shape) * std).astype(np.float32)
        if tf_name.endswith(("pop_variance", "gamma")):
            arr = np.abs(arr) + 0.5
        tensors[tf_name] = arr
    if task == "separator":
        tensors["Variable"] = np.array(545000, np.int64)
    write_bundle(prefix, tensors)
    return tensors


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _disagreement(state, jax_state, forward):
    """(largest tensor difference, forward-pass error) of a port
    ``state_dict`` against the JAX import's."""
    tensor = max(float((state[k] - jax_state[k]).abs().max())
                 for k in jax_state)
    got, ref = forward(state)
    return tensor, float(np.abs(got - ref).max() / (np.abs(ref).max() + 1))


@pytest.fixture(scope="module", params=["denoiser", "separator"])
def imported(request, tmp_path_factory):
    task = request.param
    jcfg, tcfg = _configs(task)
    prefix = str(tmp_path_factory.mktemp(task) / "synthetic-1000")
    tensors = synthetic_bundle(prefix, tcfg, task)
    jmodel, variables = j_init(jcfg, jax.random.PRNGKey(0), train=False)
    jax_tree = j_import(prefix, variables, task)
    flat = import_tf_checkpoint(prefix, tcfg, task)

    rng = np.random.default_rng(1)
    m = tcfg.model
    mixed = rng.standard_normal((2, m.window_frames, 201)).astype(np.float32)
    ca = rng.standard_normal((2, m.context_frames, 201)).astype(np.float32)
    cb = rng.standard_normal((2, m.context_frames, 201)).astype(np.float32)
    ref = np.asarray(jmodel.apply(jax_tree, mixed, ca, cb, False))

    def forward(state):
        model = NHANSNet(tcfg.model)
        model.load_state_dict(state, strict=True)
        with torch.no_grad():
            out = model(*(torch.from_numpy(a) for a in (mixed, ca, cb)))
        return out.numpy(), ref

    return dict(task=task, cfg=tcfg, prefix=prefix, tensors=tensors,
                flat=flat, jax_flat=_flatten(jax.device_get(jax_tree)),
                forward=forward)


@pytest.mark.parametrize("task", ["denoiser", "separator"])
def test_name_map_equals_jax(task):
    mine, theirs = port.tf_name_map(task), j_name_map(task)
    assert len(mine) == 571
    assert mine == theirs
    # the four places a hand copy goes wrong
    sfx = "noise_pos_emb" if task == "denoiser" else "noise_emb"
    assert f"resblock2_1_conv1_{sfx}/w" in mine
    assert ("resblock1_2_conv2_tembresblock1_2_conv2_temb_dense1/pop_mean"
            in mine)
    assert [n for n in range(1, 9) if f"resblock{(n + 1) // 2}_"
            f"{2 - n % 2}_transform/w" in mine] == [1, 3, 5, 7]
    assert "Variable" not in mine


def test_narrow_model_has_every_mapped_variable():
    _, tcfg = _configs("denoiser")
    keys = {port.flax_key(c, p) for c, p in port.tf_name_map().values()}
    assert keys == set(port.flax_shapes(tcfg))


def test_import_equals_jax_tensor_for_tensor(imported):
    flat, jax_flat = imported["flat"], imported["jax_flat"]
    assert set(flat) == set(jax_flat)
    assert len(flat) == 571
    for key, value in flat.items():
        assert value.dtype == np.float32
        assert value.shape == jax_flat[key].shape, key
    state, jax_state = from_flax(flat), from_flax(jax_flat)
    for key, t in jax_state.items():
        assert torch.equal(state[key], t), key
    # the biases and BatchNorm tensors came in as [1, 1, 1, C]
    tf_bias = imported["tensors"]["last_dense/b"]
    assert tf_bias.shape == (1, 1, 1, 201)
    np.testing.assert_array_equal(flat["params/last_dense/b"],
                                  tf_bias[0, 0, 0])
    # a conv kernel is HWIO in the bundle and OIHW in the port
    w = imported["tensors"]["resblock2_1_conv1/w"]
    np.testing.assert_array_equal(state["resblock3.conv1.w"].numpy(),
                                  w.transpose(3, 2, 0, 1))


def test_forward_pass_matches_jax(imported):
    tensor, forward = _disagreement(from_flax(imported["flat"]),
                                    from_flax(imported["jax_flat"]),
                                    imported["forward"])
    assert tensor == 0.0
    assert forward <= FORWARD_BAR, forward


@pytest.mark.parametrize("tf_name", ["resblock2_1_conv1/w",
                                     "embedding/noise_resblock1_1_conv2/w"])
def test_kernel_reshaped_straight_to_oihw_is_caught(imported, tf_name):
    """The by-count reshape into the port's own OIHW shape keeps every
    size and scrambles the kernel: the tensor and forward checks above
    both fail on it."""
    coll, path = port.tf_name_map(imported["task"])[tf_name]
    key = ".".join(path)
    state = from_flax(imported["flat"])
    value = imported["tensors"][tf_name]
    state[key] = torch.from_numpy(value.reshape(tuple(state[key].shape)))
    tensor, forward = _disagreement(state, from_flax(imported["jax_flat"]),
                                    imported["forward"])
    assert tensor > 0.0
    assert forward > 100 * FORWARD_BAR, forward


def test_strict_reports_missing_and_mismatched(tmp_path):
    _, tcfg = _configs("denoiser")
    prefix = str(tmp_path / "broken")
    gone, wrong = "resblock4_2_conv2/b", "last_conv/w"
    synthetic_bundle(prefix, tcfg, "denoiser", skip=(gone,), resize=(wrong,))
    with pytest.raises(ValueError) as err:
        import_tf_checkpoint(prefix, tcfg, "denoiser")
    msg = str(err.value)
    assert gone in msg and wrong in msg
    assert "(1 total), mismatched" in msg
    flat = import_tf_checkpoint(prefix, tcfg, "denoiser", strict=False)
    assert len(flat) == 569
    assert "params/resblock8/conv2/b" not in flat
    assert "params/last_conv/w" not in flat


def test_bundle_round_trip_keeps_dtype_shape_and_bytes(tmp_path):
    rng = np.random.default_rng(3)
    tensors = {"a/w": rng.standard_normal((2, 3, 4, 5)).astype(np.float32),
               "b": np.arange(7, dtype=np.int64),
               "c/x": rng.standard_normal(3)}
    write_bundle(str(tmp_path / "rt"), tensors)
    r = TFBundleReader(str(tmp_path / "rt"))
    assert sorted(r.keys()) == sorted(tensors)
    for name, arr in tensors.items():
        assert r.shape(name) == arr.shape and r.has_payload(name)
        got = r.read(name)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)


@needs_ref
def test_bundle_reader_parses_reference_index():
    r = TFBundleReader(REF_SN)
    assert len(r.entries) == 571
    assert r.shape("last_dense/w") == (13312, 201)
    assert r.shape("last_conv/w") == (5, 1, 512, 512)
    assert r.shape("embedding/noise_resblock1_1_conv1/w") == (8, 4, 1, 64)


@needs_ref
@pytest.mark.parametrize("prefix,task,extra", [
    (REF_SN, "denoiser", set()),
    (REF_SS, "separator", {"Variable"}),
])
def test_name_map_is_exact_on_reference_index(prefix, task, extra):
    missing, unmapped = port.check_name_map_against_index(prefix, task)
    assert missing == []
    assert set(unmapped) == extra


@needs_ref
def test_reference_shapes_fit_the_model():
    r = TFBundleReader(REF_SN)
    shapes = port.flax_shapes(Config.denoiser())
    for tf_name, (coll, path) in port.tf_name_map("denoiser").items():
        assert int(np.prod(r.shape(tf_name))) == int(
            np.prod(shapes[port.flax_key(coll, path)])), tf_name
