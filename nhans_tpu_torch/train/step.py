"""The training step: the batch built on the device, forward, loss,
backward, optimizer update and the BatchNorm population statistics; the
port of ``nhans_tpu/train/step.py``.

The state's ``params`` and ``batch_stats`` are the model's own parameter
and buffer tensors, keyed by ``state_dict`` name (the flax names with
``.`` for ``/``); a step updates them in place.  TF32 is off while the
step launches its work, and the process's settings come back after.

Under a mesh (``parallel/``) each rank takes its rows of the global
batch, with the global batch's random draws; its BatchNorms take the
global moments (``nn/blocks.py``).  The gradients are averaged over the
data group in one all-reduce of a flat float32 buffer before the global
gradient norm and the update, so every data rank applies the same update
to the same weights.  The reported loss is the global one.  With the
model axis the wide kernels hold blocks of their output channels, their
gradients are local to the block, and the gradient norm sums the blocks
over the model group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.data.pipeline import make_train_batch
from nhans_tpu_torch.models import init_variables
from nhans_tpu_torch.nn.model import NHANSNet, freq_weighted_mse
from nhans_tpu_torch.parallel.mesh import all_reduce_mean
from nhans_tpu_torch.parallel.sharding_rules import model_shards, shard_model
from nhans_tpu_torch.train.optim import (Optimizer, make_optimizer,
                                         make_schedule)
from nhans_tpu_torch.utils.device import full_float32


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: Any


def make_tx(cfg: Config) -> Optimizer:
    t = cfg.train
    lr = make_schedule(t.lr, t.lr_schedule, t.lr_decay_steps, t.lr_min_frac)
    return make_optimizer(t.alg, lr, t.mom)


def state_of(model: NHANSNet, tx: Optimizer, step: int = 0) -> TrainState:
    """A fresh state (optimizer initialised) over ``model``'s tensors."""
    params = dict(model.named_parameters())
    return TrainState(step=step, params=params,
                      batch_stats=dict(model.named_buffers()),
                      opt_state=tx.init({k: p.detach()
                                         for k, p in params.items()}))


def create_state(cfg: Config, generator: torch.Generator, device="cuda",
                 mesh=None) -> Tuple[NHANSNet, TrainState, Optimizer]:
    """(model, state, optimizer) with the seeded init of
    ``models.init_variables``, on the card unless the caller asks for
    ``cpu``; with a ``mesh``, put on it (``sharding_rules.shard_model``)
    before the optimizer's state is made."""
    model = init_variables(cfg, generator, device)
    if mesh is not None:
        shard_model(model, mesh)
    tx = make_tx(cfg)
    return model, state_of(model, tx), tx


def param_counts(state: TrainState) -> Tuple[int, int]:
    """(trainable, non-trainable) element counts."""
    count = lambda d: sum(int(np.prod(v.shape)) for v in d.values())  # noqa: E731
    return count(state.params), count(state.batch_stats)


def train_loss(cfg: Config, model: NHANSNet, ex: Dict[str, torch.Tensor],
               embed_noise=None, mesh=None, rows=None) -> torch.Tensor:
    """The frequency-weighted MSE of the denoised central frames, with the
    near-clean windows upweighted under ``clean_loss_boost``: normalised
    to mean 1 over the global batch under a ``mesh``.  ``rows`` places
    this rank's examples for the embedding jitter
    (``NHANSNet.forward``)."""
    W = cfg.model.window_frames
    res = model(ex["mixed"], ex["ctx_a"], ex["ctx_b"], embed_noise=embed_noise,
                noise_rows=rows)
    center = ex["mixed"][:, W // 2, :]
    loss, ex_loss = freq_weighted_mse(center + res, ex["target"])
    boost = cfg.train.clean_loss_boost
    if boost > 0.0:
        # a window whose central frame is already near the target weighs
        # 1 + boost * sigmoid((dist - d) / scale), normalised to mean 1
        d = torch.mean(torch.abs(center - ex["target"]), dim=-1)
        wts = 1.0 + boost * torch.sigmoid(
            (cfg.train.clean_loss_dist - d) / cfg.train.clean_loss_scale)
        group = mesh.data_group if mesh is not None else None
        wts = wts / all_reduce_mean(torch.mean(wts), group)
        loss = torch.mean(ex_loss * wts)
    return loss


def _average_grads(grads: Dict[str, torch.Tensor], group
                   ) -> Dict[str, torch.Tensor]:
    """The gradients averaged over ``group``, in one all-reduce of a flat
    float32 buffer."""
    if group is None:
        return grads
    flat = torch.cat([g.reshape(-1).to(torch.float32)
                      for g in grads.values()])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, at = {}, 0
    for k, g in grads.items():
        out[k] = flat[at:at + g.numel()].view_as(g).to(g.dtype)
        at += g.numel()
    return out


def _global_norm(grads: Dict[str, torch.Tensor], shards: dict,
                 model_group) -> torch.Tensor:
    """The norm of the whole gradient: the replicated tensors' squares
    plus the model-axis blocks' squares summed over the model group."""
    total = sum(torch.sum(g * g) for k, g in grads.items()
                if k not in shards)
    if shards:
        blocks = sum(torch.sum(grads[k] * grads[k]) for k in shards)
        dist.all_reduce(blocks, group=model_group)
        total = total + blocks
    return torch.sqrt(total)


def make_train_step(cfg: Config, model: NHANSNet, tx: Optimizer,
                    banked: bool = False, mesh=None):
    """The step function.

    ``step(state, batch, generator) -> metrics``, where ``batch`` holds
    the waveform buffers clean/noise_a/noise_b [B, L] (int16 or float32),
    their lengths clean_len/len_a/len_b [B] and optionally whole-file
    peaks [B, 3], on the model's device.  With ``banked=True`` it is
    ``step(state, banks, idx, generator)``: ``banks`` are the
    ``DeviceBanks`` tensors and ``idx`` the index triples
    clean_idx/a_idx/b_idx [B], and the rows are gathered on the device.

    ``generator`` gives every random draw of the step (the batch's, then
    the context-embedding jitter's); ``draws`` may supply the batch's
    instead (``data.pipeline.draw_train_batch``).  The state is updated
    in place; ``metrics`` holds the loss and the global gradient norm as
    0-d device tensors, so that nothing synchronises the host.

    With a ``mesh`` (the model already on it, ``create_state``), ``batch``
    and ``idx`` are this rank's rows of the global batch, every rank
    passes a generator in the same state, and ``draws`` (if given) are
    the global batch's."""
    noise = cfg.model.ctx_embed_noise > 0.0
    data_group = mesh.data_group if mesh is not None else None
    shards = model_shards(model) if mesh is not None else {}

    def core(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator, draws=None
             ) -> Dict[str, torch.Tensor]:
        with full_float32():
            B = batch["clean"].shape[0]
            rows = None
            if mesh is not None:
                rows = (mesh.data_index * B, mesh.data * B)
            ex = make_train_batch(cfg, batch["clean"], batch["noise_a"],
                                  batch["noise_b"], batch["clean_len"],
                                  batch["len_a"], batch["len_b"],
                                  peaks=batch.get("peaks"), draws=draws,
                                  generator=generator, rows=rows)
            model.train()
            for p in state.params.values():
                p.grad = None
            if rows is not None:  # in examples: B utterances x K crops
                n = ex["mixed"].shape[0]
                rows = (mesh.data_index * n, mesh.data * n)
            loss = train_loss(cfg, model, ex, generator if noise else None,
                              mesh, rows)
            loss.backward()
            with torch.no_grad():
                grads = {k: (p.grad if p.grad is not None
                             else torch.zeros_like(p))
                         for k, p in state.params.items()}
                grads = _average_grads(grads, data_group)
                gnorm = _global_norm(grads, shards, mesh and mesh.model_group)
                updates, state.opt_state = tx.update(grads, state.opt_state)
                for k, p in state.params.items():
                    p.add_(updates[k])
                    p.grad = None
        state.step += 1
        return {"loss": all_reduce_mean(loss.detach(), data_group),
                "grad_norm": gnorm}

    if not banked:
        return core

    def banked_step(state: TrainState, banks: Dict[str, torch.Tensor],
                    idx: Dict[str, torch.Tensor],
                    generator: torch.Generator, draws=None
                    ) -> Dict[str, torch.Tensor]:
        dev = banks["speech"].device
        ci, ai, bi = (idx[k].to(dev, torch.int64)
                      for k in ("clean_idx", "a_idx", "b_idx"))
        batch = {
            "clean": banks["speech"].index_select(0, ci),
            "noise_a": banks["noise"].index_select(0, ai),
            "noise_b": banks["noise"].index_select(0, bi),
            "clean_len": banks["speech_len"].index_select(0, ci),
            "len_a": banks["noise_len"].index_select(0, ai),
            "len_b": banks["noise_len"].index_select(0, bi),
            "peaks": torch.stack(
                [banks["speech_peak"].index_select(0, ci),
                 banks["noise_peak"].index_select(0, ai),
                 banks["noise_peak"].index_select(0, bi)], dim=1),
        }
        return core(state, batch, generator, draws)

    return banked_step


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of training step ``step``: a pure function of
    (seed, step), so that a resumed run replays an uninterrupted one."""
    g = torch.Generator()
    g.manual_seed(int(np.random.SeedSequence([seed, step])
                      .generate_state(1, np.uint64)[0] >> 1))
    return g
