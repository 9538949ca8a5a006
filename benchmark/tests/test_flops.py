"""The yardstick's operation counts against torch's own count of the
program at the published widths (on the meta device: shapes only, no
arithmetic), and its independence of the padded tower."""

import dataclasses
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark.serving import port_config

CONFIG = harness.load_json(os.path.join(harness.HERE, "configs",
                                        "nhans-denoiser.json"))


def _positions(cfg: dict) -> int:
    """Operations of the position MLPs in one call of the main tower (2
    MLPs per inject, 2 injects per block, at the block's output sizes)."""
    T, F, total = cfg["window_frames"], cfg["num_bins"], 0
    h = cfg["pos_embed_hidden"]
    for k, s, c in cfg["main_blocks"]:
        T, F = -(-T // s), -(-F // s)
        total += 2 * sum(2 * n * (h + h * h + h * c) for n in (T, F))
    return total


def _model(freq_pad_to: int = 0):
    from nhans_tpu_torch.nn.model import NHANSNet

    pc = port_config(CONFIG)
    model_cfg = dataclasses.replace(pc.model, freq_pad_to=freq_pad_to)
    with torch.device("meta"):
        return NHANSNet(model_cfg)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_window_flops_equal_torch_count_at_full_width():
    n = 64
    model = _model()
    w = torch.empty((n, 35, 201), device="meta")
    e = torch.empty((n, 512), device="meta")
    port = _count(lambda: model(w, emb_a=e, emb_b=e))
    assert port == n * flops.window_flops(CONFIG) + _positions(CONFIG)
    assert flops.window_flops(CONFIG) == 10_335_010_176


def test_padded_tower_counts_more_and_the_yardstick_does_not_move():
    n = 64
    w = torch.empty((n, 35, 201), device="meta")
    e = torch.empty((n, 512), device="meta")
    native = _count(lambda: _model()(w, emb_a=e, emb_b=e))
    padded = _count(lambda: _model(256)(w, emb_a=e, emb_b=e))
    assert padded > 1.2 * native
    # the yardstick reads the configuration's shapes, not the program's
    assert native >= n * flops.window_flops(CONFIG)


def test_context_flops_equal_torch_count():
    model = _model()
    c = torch.empty((8, 200, 201), device="meta")
    assert _count(lambda: model.embedding(c)) == 8 * flops.context_flops(CONFIG)


@pytest.mark.parametrize("examples", [4, 64])
def test_train_step_flops_equal_torch_count(examples):
    """Forward and backward of a step of ``examples`` windows with their
    contexts, the position MLPs' share taken out."""
    model = _model()
    model.train()
    w = torch.empty((examples, 35, 201), device="meta")
    c = torch.empty((examples, 200, 201), device="meta")

    def step():
        model(w, c, c).sum().backward()

    port = _count(step)
    # the position MLPs: forward, then weight and input gradients but
    # for the first layer's input (the positions themselves)
    pos = _positions(CONFIG)
    h = CONFIG["pos_embed_hidden"]
    T, F, first = CONFIG["window_frames"], CONFIG["num_bins"], 0
    for k, s, ch in CONFIG["main_blocks"]:
        T, F = -(-T // s), -(-F // s)
        first += 2 * sum(2 * n * h for n in (T, F))
    assert port == flops.train_step_flops(CONFIG, examples) + 3 * pos - first
    if examples == 64:
        assert flops.train_step_flops(CONFIG, examples) == 7_783_788_331_008


def test_spectrogram_bytes():
    assert flops.spectrogram_bytes(160000, 998, 201, True) == \
        4 * 160000 + 12 * 998 * 201
    assert flops.spectrogram_bytes(100, 1, 201, False) == 400 + 804
