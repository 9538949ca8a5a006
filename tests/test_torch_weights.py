"""The shipped flat .npz checkpoints load into the port one key for one
tensor: every one of the 571 keys maps to exactly one parameter or buffer
of NHANSNet with the right shape, and the trainable count is 28,980,937."""

import numpy as np
import pytest
import torch

from nhans_tpu_torch.compat.weights import from_flax, load_npz
from nhans_tpu_torch.config import Config
from nhans_tpu_torch.models import build_model
from tests.make_torch_golden import DENOISER_NPZ, SEPARATOR_NPZ

TRAINABLE = 28_980_937


@pytest.mark.parametrize("npz", [DENOISER_NPZ, SEPARATOR_NPZ])
def test_every_key_maps_to_one_tensor(npz):
    with np.load(npz) as z:
        flat = {k: z[k] for k in z.files}
    assert len(flat) == 571
    state = from_flax(flat)
    model = build_model(Config.denoiser())
    want = model.state_dict()
    assert sorted(state) == sorted(want)
    for key, t in state.items():
        assert t.dtype == torch.float32
        assert t.shape == want[key].shape, key
    params = {n for n, _ in model.named_parameters()}
    buffers = {n for n, _ in model.named_buffers()}
    assert params == {k[len("params/"):].replace("/", ".")
                      for k in flat if k.startswith("params/")}
    assert buffers == {k[len("batch_stats/"):].replace("/", ".")
                       for k in flat if k.startswith("batch_stats/")}
    assert sum(p.numel() for p in model.parameters()) == TRAINABLE
    assert sum(flat[k].size for k in flat if k.startswith("params/")) \
        == TRAINABLE


def test_layouts_of_conv_dense_and_stats():
    state = load_npz(DENOISER_NPZ)
    with np.load(DENOISER_NPZ) as z:
        conv = z["params/resblock3/conv1/w"].astype(np.float32)      # HWIO
        dense = z["params/last_dense/w"].astype(np.float32)          # [in, out]
        mean = z["batch_stats/last_bn/pop_mean"]
    np.testing.assert_array_equal(state["resblock3.conv1.w"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["last_dense.w"].numpy(), dense)
    np.testing.assert_array_equal(state["last_bn.pop_mean"].numpy(), mean)


def test_unknown_collection_is_refused():
    with pytest.raises(KeyError):
        from_flax({"opt_state/mu/w": np.zeros(3)})
