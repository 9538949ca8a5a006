"""The port's multi-device layer in one process (nhans_tpu_torch/parallel/,
infer/enhance.py ``devices``), against the JAX package's
nhans_tpu/parallel/ and its mesh Enhancer on the conftest's 8-device CPU
mesh.

* ``process_shard`` and ``local_batch_size`` follow the JAX functions.
* ``make_mesh`` without a process group is one rank and refuses a mesh
  the world cannot hold, naming both sizes.
* The model axis's rule picks the JAX rule's tensors of the full model;
  optimizer slots follow their parameter.
* ``Enhancer(devices=["cpu", "cpu"])`` equals the unsplit Enhancer and
  the JAX ``Enhancer(mesh=make_mesh(data=2))`` within 1e-4 (waveforms of
  peak about 1; the split is exact up to the batch size's effect on
  float sums), for a batch and the segmented long path, at reduced
  widths with seeded weights; a count of 3 devices is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from nhans_tpu.infer.enhance import Enhancer as JEnhancer
from nhans_tpu.models import build_model as j_build_model
from nhans_tpu.parallel.mesh import local_batch_size as j_local_batch_size
from nhans_tpu.parallel.mesh import make_mesh as j_make_mesh
from nhans_tpu.parallel.mesh import process_shard as j_process_shard
from nhans_tpu.parallel.sharding_rules import \
    param_sharding_rules as j_param_sharding_rules
from nhans_tpu_torch.cli._app import mesh_devices
from nhans_tpu_torch.compat.weights import from_flax
from nhans_tpu_torch.infer.enhance import Enhancer
from nhans_tpu_torch.models import build_model
from nhans_tpu_torch.parallel import (Mesh, local_batch_size, make_mesh,
                                      process_shard)
from nhans_tpu_torch.parallel.sharding_rules import (param_sharding_rules,
                                                     state_sharding)
from nhans_tpu_torch.train.step import make_tx, state_of
from tests.make_torch_golden import twin_configs
from tests.test_torch_train_step import SMALL_MODEL, _nest, _variables

WAVE_ATOL = 1e-4


def test_process_shard_and_local_batch_size_follow_jax():
    items = [f"u{i}" for i in range(10)]
    for count in (1, 2, 3, 4, 16):
        for index in range(count):
            assert (process_shard(items, index, count)
                    == j_process_shard(items, index, count))
    assert process_shard(["a"], 3, 4) == ["a"]
    # one process: a JAX host feeds all of its devices' rows, a port rank
    # one device's
    for data in (1, 2, 4, 8):
        jmesh = j_make_mesh(data=data)
        for global_batch in range(1, 18):
            assert (local_batch_size(global_batch, Mesh(data, 1, 0))
                    == j_local_batch_size(global_batch, jmesh) // data)


def test_make_mesh_without_a_process_group():
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.rank) == (1, 1, 0)
    assert mesh.data_group is None and mesh.model_group is None
    assert make_mesh(data=0, model=1).size == 1
    for data, model in ((2, 1), (0, 2), (1, 2)):
        with pytest.raises(ValueError) as err:
            make_mesh(data=data, model=model)
        assert f"model={model}" in str(err.value)
        assert "the world has 1" in str(err.value)


def test_model_axis_rule_picks_the_jax_tensors():
    jcfg, tcfg = twin_configs("denoiser")
    m = jcfg.model
    abstract = jax.eval_shape(
        lambda k: j_build_model(jcfg).init(
            k, jnp.zeros((1, m.window_frames, m.num_features)),
            jnp.zeros((1, m.context_frames, m.num_features)),
            jnp.zeros((1, m.context_frames, m.num_features)), train=True),
        jax.random.PRNGKey(0))["params"]
    model = build_model(tcfg)
    params = dict(model.named_parameters())
    for data, model_size in ((4, 2), (2, 4), (8, 1)):
        specs = j_param_sharding_rules(j_make_mesh(data=data,
                                                   model=model_size),
                                       abstract)
        want = {".".join(k) for k, v in flatten_dict(
            specs, keep_empty_nodes=False).items() if "model" in str(v.spec)}
        rules = param_sharding_rules(Mesh(data, model_size, 0), params)
        got = {k for k, d in rules.items() if d is not None}
        assert got == want, (model_size, sorted(got ^ want))
    # the 512-wide tower layers at model=2: convolutions split on OIHW's
    # dim 0, dense kernels on [in, out]'s dim 1
    rules = param_sharding_rules(Mesh(4, 2, 0), params)
    assert rules["resblock8.conv2.w"] == 0
    assert rules["resblock8.inject1.proj_a.w"] == 1
    assert rules["resblock8.conv2.b"] is None
    assert rules["embedding.block1.conv1.w"] is None
    tx = make_tx(tcfg)
    sh = state_sharding(Mesh(4, 2, 0), state_of(model, tx), True)
    for slot, dims in sh["opt_state"].items():
        assert dims == {k: rules[k] for k in dims}, slot
    assert set(sh["batch_stats"].values()) == {None}
    off = state_sharding(Mesh(4, 2, 0), state_of(model, tx))
    assert set(off["params"].values()) == {None}


@pytest.fixture(scope="module")
def small_enhancers():
    """(JAX mesh Enhancer over 2 devices, port Enhancer on one CPU device,
    port Enhancer split over two) with the same seeded reduced-width
    weights."""
    jcfg, tcfg = twin_configs("denoiser", model=SMALL_MODEL)
    flat = _variables(jcfg, seed=4)
    variables = {"params": _nest({k[7:]: v for k, v in flat.items()
                                  if k.startswith("params/")}),
                 "batch_stats": _nest({k[12:]: v for k, v in flat.items()
                                       if k.startswith("batch_stats/")})}
    kw = dict(window_chunk=32, buckets_seconds=(0.5,))
    jenh = JEnhancer(jcfg, variables, out_wire="float32",
                     mesh=j_make_mesh(data=2), **kw)
    state = from_flax(flat)
    return (jenh, Enhancer(tcfg, state, device="cpu", **kw),
            Enhancer(tcfg, state, devices=["cpu", "cpu"], **kw))


def _signals(seed):
    rng = np.random.default_rng(seed)
    mixed = [rng.standard_normal(n) * (500 + 300 * i)
             for i, n in enumerate((6400, 7000, 4100))]
    return mixed, rng.standard_normal(3000) * 400, \
        rng.standard_normal(9000) * 800


def _assert_same(got, ref):
    for key in ("denoised", "mixed_processed", "removed"):
        for g, r in zip(got[key], ref[key]):
            assert np.shape(g) == np.shape(r), key
            np.testing.assert_allclose(g, r, atol=WAVE_ATOL, err_msg=key)
    np.testing.assert_allclose(got["snr_est"], ref["snr_est"], rtol=1e-4)


def test_enhancer_split_over_devices_matches(small_enhancers):
    jenh, one, two = small_enhancers
    assert [d.type for d in two.devices] == ["cpu", "cpu"]
    assert two.models[0] is not two.models[1]
    mixed, pos, neg = _signals(0)
    want = jenh.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    ref = one.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    got = two.enhance_batch(mixed, [pos] * 3, [neg] * 3)
    _assert_same(got, ref)
    _assert_same(got, want)
    # a batch of one still gives each device a row
    _assert_same(two.enhance_batch(mixed[:1], [pos], [neg]),
                 one.enhance_batch(mixed[:1], [pos], [neg]))
    # the segmented long path fans its segments out the same way
    long = np.concatenate(mixed)
    kw = dict(segment_seconds=0.25, segment_batch=3)
    want = jenh.enhance_long(long, pos, neg, **kw)
    got = two.enhance_long(long, pos, neg, **kw)
    np.testing.assert_allclose(got["denoised"], want["denoised"],
                               atol=WAVE_ATOL)
    np.testing.assert_allclose(got["denoised"],
                               one.enhance_long(long, pos, neg,
                                                **kw)["denoised"],
                               atol=WAVE_ATOL)


def test_enhancer_device_count_must_be_a_power_of_two(small_enhancers):
    _, one, _ = small_enhancers
    state = one.model.state_dict()
    with pytest.raises(ValueError, match="power of two"):
        Enhancer(one.cfg, state, devices=["cpu"] * 3)
    # --mesh auto: without a card, or with --mesh off, one device
    assert mesh_devices("auto", "cpu") == [torch.device("cpu")]
    assert mesh_devices("off", "cpu") == [torch.device("cpu")]
