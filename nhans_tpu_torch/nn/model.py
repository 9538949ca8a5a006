"""The N-HANS conditional ResNet as torch.nn modules: the port of
``nhans_tpu/nn/model.py``.

* a shared context tower: 4 strided residual conv blocks
  (64 -> 128 -> 256 -> 512) and a global average pool -> 512-d embedding,
  applied to both context spectrograms;
* the main tower: 8 residual conv blocks whose every conv output is
  conditioned by projections of the two embeddings plus time- and
  frequency-position MLP embeddings;
* the head: a time-collapsing VALID conv and a dense layer -> a 201-d
  residual added to the central mixed frame.

The public functions take ``[B, W, F]`` (time, frequency) as the JAX
package does; inside, tensors are NCHW with time as H and frequency as W.
Module and parameter names are the flax names, so ``state_dict`` keys are
the checkpoint's keys with ``/`` read as ``.``.  ``model.train()`` gives
the training forward (batch moments and the population EMA in every
BatchNorm, and the optional context-embedding jitter); ``model.eval()``
the serving one.

``ModelConfig`` selects the compute dtype (``compute_dtype``: the layers
cast where the flax modules do, and the residual comes back float32), the
lane-padded geometry of the main tower (``freq_pad_to``) and
rematerialisation of its blocks in the backward pass (``remat``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nhans_tpu_torch.config import ModelConfig
from nhans_tpu_torch.nn.blocks import (BatchNorm, Conv, Dense, frozen_stats,
                                       same_pads)
from nhans_tpu_torch.ops.tower_conv import (KERNEL_SHAPES, TrainConv,
                                            tower_conv)
from nhans_tpu_torch.ops.tower_epilogue import tower_epilogue
from nhans_tpu_torch.ops.train_epilogue import TrainEpilogue
from nhans_tpu_torch.utils.device import to_device


class PositionalMLP(nn.Module):
    """Embeds positions 0..n-1 through a 1 -> 50 -> 50 -> out_dim MLP with
    BN + ReLU between the layers.  -> [n, out_dim]"""

    def __init__(self, out_dim: int, hidden: int = 50, bn_eps: float = 1e-3,
                 bn_decay: float = 0.95, w_std: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense1 = Dense(1, hidden, use_bias=False, w_std=w_std,
                            dtype=dtype)
        self.bn1 = BatchNorm(hidden, bn_eps, bn_decay, dtype)
        self.dense2 = Dense(hidden, hidden, use_bias=False, w_std=w_std,
                            dtype=dtype)
        self.bn2 = BatchNorm(hidden, bn_eps, bn_decay, dtype)
        self.dense3 = Dense(hidden, out_dim, use_bias=False, w_std=0.0,
                            dtype=dtype)

    def forward(self, n: int, device) -> torch.Tensor:
        x = torch.arange(n, dtype=torch.float32, device=device)[:, None]
        x = F.relu(self.bn1(self.dense1(x)))
        x = F.relu(self.bn2(self.dense2(x)))
        return self.dense3(x)


class ContextBlock(nn.Module):
    """Conv-BN-ReLU-conv residual block with a strided 1x1 shortcut when
    the channel count changes.  ``conv1`` and ``conv2`` run through
    ``_train_conv``, each epilogue through ``_train_epilogue``."""

    def __init__(self, in_features: int, features: int, kernel: Sequence[int],
                 strides: Sequence[int], bn_eps: float = 1e-3,
                 bn_decay: float = 0.95, w_std: float = 0.01,
                 b_init: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_residual(in_features, features, strides)
        p = dict(w_std=w_std, b_init=b_init, dtype=dtype)
        self.conv1 = Conv(in_features, features, kernel, strides,
                          use_bias=False, **p)
        self.bn1 = BatchNorm(features, bn_eps, bn_decay, dtype)
        self.conv2 = Conv(features, features, kernel, (1, 1), **p)
        self.transform = (Conv(in_features, features, (1, 1), strides, **p)
                          if in_features != features else None)
        self.bn_out = BatchNorm(features, bn_eps, bn_decay, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        path1 = _train_epilogue(self.bn1, _train_conv(self.conv1, x))
        path1 = _train_conv(self.conv2, path1)
        path2 = x if self.transform is None else self.transform(x)
        return _train_epilogue(self.bn_out, path1, residual=path2)


class ContextEncoder(nn.Module):
    """The shared context tower: [B, context_frames, F] -> [B, 512]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        cin = 1
        for i, (kernel, strides, features) in enumerate(cfg.context_blocks):
            self.add_module(f"block{i + 1}", ContextBlock(
                cin, features, kernel, strides, cfg.bn_eps, cfg.bn_decay,
                cfg.w_std, cfg.b_init, compute_dtype(cfg)))
            cin = features

    def forward(self, ctx: torch.Tensor) -> torch.Tensor:
        x = ctx[:, None]
        for block in self.children():
            x = block(x)
        # global average pool, summed in float32 and returned in the
        # compute dtype, as jnp.mean does
        return torch.mean(x, dim=(2, 3), dtype=torch.float32).to(x.dtype)


class Inject(nn.Module):
    """Adds projections of both context embeddings and the learned time-
    and frequency-position embeddings to an NCHW activation.  Each
    position MLP is evaluated at the size of the tensor it is added to."""

    def __init__(self, features: int, embedding_dim: int = 512,
                 hidden: int = 50, bn_eps: float = 1e-3,
                 bn_decay: float = 0.95, w_std: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj_a = Dense(embedding_dim, features, w_std=0.0, dtype=dtype)
        self.proj_b = Dense(embedding_dim, features, w_std=0.0, dtype=dtype)
        self.temb = PositionalMLP(features, hidden, bn_eps, bn_decay, w_std,
                                  dtype)
        self.femb = PositionalMLP(features, hidden, bn_eps, bn_decay, w_std,
                                  dtype)

    def forward(self, x: torch.Tensor, emb_a: torch.Tensor,
                emb_b: torch.Tensor) -> torch.Tensor:
        a = self.proj_a(emb_a)[:, :, None, None]
        b = self.proj_b(emb_b)[:, :, None, None]
        t = self.temb(x.shape[2], x.device).t()[None, :, :, None]
        f = self.femb(x.shape[3], x.device).t()[None, :, None, :]
        return x + a + b + t + f

    def tables(self, x: torch.Tensor, emb_a: torch.Tensor,
               emb_b: torch.Tensor):
        """What ``forward`` adds to ``x``, unbroadcast: a, b [N, C],
        t [C, H] and f [C, W], for ``ops.tower_epilogue``."""
        a, b, t, f = self.train_tables(x, emb_a, emb_b)
        return a, b, t.t().contiguous(), f.t().contiguous()

    def train_tables(self, x: torch.Tensor, emb_a: torch.Tensor,
                     emb_b: torch.Tensor):
        """What ``forward`` adds to ``x``, unbroadcast and as the layers
        give it: a, b [N, C], t [H, C] and f [W, C], for
        ``ops.train_epilogue``."""
        return (self.proj_a(emb_a), self.proj_b(emb_b),
                self.temb(x.shape[2], x.device),
                self.femb(x.shape[3], x.device))


class CondResBlock(nn.Module):
    """Residual conv block with conditioning injected after each of its
    two convolutions.

    ``freq_valid`` > 0 selects the lane-padded geometry
    (``ModelConfig.freq_pad_to``): the incoming frequency axis is wider
    than the ``freq_valid`` true bins, which the columns beyond carry as
    zeros.  The convolutions pad as TF-SAME would at the true width, and
    the dead columns are zeroed again after ``bn1`` and after the output
    ReLU, so that the boundary taps read the zeros SAME padding gives.
    In inference every BatchNorm is a per-channel affine map, so the
    valid columns equal the native geometry's; in training the batch
    moments include the dead columns.

    In inference with grad off, each convolution is followed by one
    ``ops.tower_epilogue`` (conditioning, ``bn1`` and ReLU; conditioning,
    the residual, ``bn_out`` and ReLU) in place of the modules, with the
    same result bit for bit; in float32 compute ``conv1`` and ``conv2``
    run through ``ops.tower_conv`` (``_conv`` says when), whose kernel sums
    in another order than cuDNN and whose plain version, which a CPU
    tensor takes, is ``Conv.forward``.  In training or with grad on, the
    convolutions run through ``_train_conv`` and the epilogues through
    ``_train_epilogue``."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int, embedding_dim: int = 512, hidden: int = 50,
                 bn_eps: float = 1e-3, bn_decay: float = 0.95,
                 w_std: float = 0.01, b_init: float = 0.0,
                 dtype: torch.dtype = torch.float32, freq_valid: int = 0):
        super().__init__()
        k, s = kernel, stride
        _check_residual(in_features, features, (s, s))
        p = dict(w_std=w_std, b_init=b_init, dtype=dtype)
        inj = (features, embedding_dim, hidden, bn_eps, bn_decay, w_std,
               dtype)
        self.freq_valid = freq_valid
        self.freq_out = same_pads(freq_valid, k, s)[2] if freq_valid else 0
        self.conv1 = Conv(in_features, features, (k, k), (s, s),
                          use_bias=False, **p)
        self.inject1 = Inject(*inj)
        self.bn1 = BatchNorm(features, bn_eps, bn_decay, dtype)
        self.conv2 = Conv(features, features, (k, k), (1, 1), **p)
        self.inject2 = Inject(*inj)
        self.transform = (Conv(in_features, features, (1, 1), (s, s), **p)
                          if in_features != features else None)
        self.bn_out = BatchNorm(features, bn_eps, bn_decay, dtype)

    def _mask(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` with the columns past the true width zeroed."""
        return _keep_columns(y, self.freq_out)

    def forward(self, x: torch.Tensor, emb_a: torch.Tensor,
                emb_b: torch.Tensor) -> torch.Tensor:
        if not (self.training or torch.is_grad_enabled()):
            return self._fused(x, emb_a, emb_b)
        fv, fv1 = self.freq_valid or None, self.freq_out or None
        embs = (emb_a, emb_b)
        path1 = _train_epilogue(self.bn1, _train_conv(self.conv1, x, fv),
                                self.inject1, embs, valid=self.freq_out)
        path1 = _train_conv(self.conv2, path1, fv1)
        path2 = x if self.transform is None else self.transform(x)
        return _train_epilogue(self.bn_out, path1, self.inject2, embs,
                               path2, self.freq_out)

    def _fused(self, x: torch.Tensor, emb_a: torch.Tensor,
               emb_b: torch.Tensor) -> torch.Tensor:
        """The inference forward with one epilogue per convolution.  Each
        activation is dropped as soon as the next one exists, as in the
        modules' forward, so that no convolution runs beside one more."""
        fv, fv1 = self.freq_valid or None, self.freq_out or None
        y = _conv(self.conv1, x, fv)
        y = tower_epilogue(y, *self.inject1.tables(y, emb_a, emb_b),
                           *self.bn1.eval_affine(), valid=self.freq_out)
        y = _conv(self.conv2, y, fv1)
        path2 = x if self.transform is None else self.transform(x)
        return tower_epilogue(y, *self.inject2.tables(y, emb_a, emb_b),
                              *self.bn_out.eval_affine(), residual=path2,
                              valid=self.freq_out)


def _kernel_takes(conv: Conv, x: torch.Tensor) -> bool:
    """Whether the input and the compute dtype are float32, ``conv`` holds
    all its output channels and its kernel is one the kernels take (every
    k x k one of both published towers)."""
    return (x.dtype == torch.float32 and conv.dtype == torch.float32
            and conv.shard is None and conv.kernel_size in KERNEL_SHAPES)


def _conv(conv: Conv, x: torch.Tensor,
          freq_size: Optional[int]) -> torch.Tensor:
    """``conv(x, freq_size)``, through ``ops.tower_conv`` where
    ``_kernel_takes`` holds."""
    if not _kernel_takes(conv, x):
        return conv(x, freq_size)
    return tower_conv(x, conv.w, conv.b, conv.strides,
                      conv.pads(x, freq_size))


# the sets that ``hand_convs`` and ``hand_epilogues`` collect into,
# innermost last
_COLLECTING = {"convs": [], "epilogues": []}
# the devices whose tensors ``_train_conv`` and ``_train_epilogue`` send to
# the kernels
KERNEL_DEVICES = ("cuda",)


@contextlib.contextmanager
def _collect(kind: str):
    seen: set = set()
    _COLLECTING[kind].append(seen)
    try:
        yield seen
    finally:
        _COLLECTING[kind].remove(seen)


def hand_convs():
    """Collects, into the set it yields, the convolutions that
    ``_train_conv`` sends to the kernels while inside."""
    return _collect("convs")


def hand_epilogues():
    """Collects, into the set it yields, the BatchNorms whose epilogues
    ``_train_epilogue`` sends to the kernels while inside."""
    return _collect("epilogues")


def _train_conv(conv: Conv, x: torch.Tensor,
                freq_size: Optional[int] = None) -> torch.Tensor:
    """``conv(x, freq_size)``; with grad on, on a CUDA tensor, where
    ``_kernel_takes`` holds, through ``ops.tower_conv.TrainConv``: the
    forward and the weight and bias gradients on the hand-written kernels,
    and the input gradient too at stride 1.  Elsewhere the module runs as
    it is."""
    if not (torch.is_grad_enabled() and x.device.type in KERNEL_DEVICES
            and _kernel_takes(conv, x)):
        return conv(x, freq_size)
    for seen in _COLLECTING["convs"]:
        seen.add(conv)
    return TrainConv.apply(x, conv.w, conv.b, conv.strides,
                           conv.pads(x, freq_size))


def _keep_columns(y: torch.Tensor, valid: int) -> torch.Tensor:
    """``y`` times 0 at the columns ``valid`` and beyond (``valid`` 0:
    ``y`` as it is)."""
    if not valid:
        return y
    keep = torch.arange(y.shape[3], device=y.device) < valid
    return y * keep.to(y.dtype)


def _epilogue_modules(bn: BatchNorm, y: torch.Tensor,
                      inject: Optional[Inject] = None, embs=(),
                      residual: Optional[torch.Tensor] = None,
                      valid: int = 0) -> torch.Tensor:
    """``relu(bn(inject(y, *embs) [+ residual]))``, the columns at
    ``valid`` and beyond zeroed, as the modules compute it."""
    v = y if inject is None else inject(y, *embs)
    if residual is not None:
        v = v + residual
    return _keep_columns(F.relu(bn(v)), valid)


def _train_epilogue(bn: BatchNorm, y: torch.Tensor,
                    inject: Optional[Inject] = None, embs=(),
                    residual: Optional[torch.Tensor] = None,
                    valid: int = 0) -> torch.Tensor:
    """``_epilogue_modules``; with grad on, ``bn`` in training with the
    moments of this rank's batch alone, on a CUDA tensor, in float32 input
    and compute, through ``ops.train_epilogue.TrainEpilogue``: the forward
    and backward on the hand-written kernels, the moments in float64.
    Elsewhere the modules run as they are."""
    if not (torch.is_grad_enabled() and bn.training and bn.group is None
            and y.device.type in KERNEL_DEVICES
            and y.dtype == torch.float32 and bn.dtype == torch.float32):
        return _epilogue_modules(bn, y, inject, embs, residual, valid)
    for seen in _COLLECTING["epilogues"]:
        seen.add(bn)
    tables = ((None,) * 4 if inject is None
              else inject.train_tables(y, *embs))
    return TrainEpilogue.apply(y, residual, *tables, bn.gamma, bn.beta, bn,
                               valid)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.compute_dtype``."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype must be one of {sorted(dtypes)}, "
                         f"got {cfg.compute_dtype!r}")
    return dtypes[cfg.compute_dtype]


def _check_residual(in_features: int, features: int,
                    strides: Sequence[int]) -> None:
    """An identity shortcut needs an unstrided block: otherwise the two
    paths of the residual add would disagree in size."""
    if in_features == features and tuple(strides) != (1, 1):
        raise ValueError(f"block keeps {features} channels but has strides "
                         f"{tuple(strides)}: its identity shortcut would not "
                         "match the strided path")


class NHANSNet(nn.Module):
    """The full model.  ``forward`` returns the predicted residual for the
    central frame of each window: denoised = mixed[:, W // 2] + residual.

    ``ctx_a`` is the first context (positive noise for the denoiser,
    interference speaker for the separator), ``ctx_b`` the second
    (negative noise / target speaker)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg)
        self.embedding = ContextEncoder(cfg)
        emb_dim = cfg.context_blocks[-1][2]  # width of the context tower
        # lane padding: the true width enters the blocks padded to
        # freq_pad_to columns, and each block carries its true width on
        self.freq_pad = (cfg.freq_pad_to
                         if cfg.freq_pad_to > cfg.num_features else 0)
        cin, t, f = 1, cfg.window_frames, cfg.num_features
        for i, (k, s, c) in enumerate(cfg.main_blocks):
            self.add_module(f"resblock{i + 1}", CondResBlock(
                cin, c, k, s, emb_dim, cfg.pos_embed_hidden, cfg.bn_eps,
                cfg.bn_decay, cfg.w_std, cfg.b_init, dtype,
                freq_valid=f if self.freq_pad else 0))
            cin, t, f = c, same_pads(t, k, s)[2], same_pads(f, k, s)[2]
        self.num_blocks = len(cfg.main_blocks)
        self.freq_out = f
        self.last_conv = Conv(cin, cfg.embedding_dim, (t, 1),
                              padding="VALID", use_bias=False,
                              w_std=cfg.w_std, dtype=dtype)
        self.last_bn = BatchNorm(cfg.embedding_dim, cfg.bn_eps, cfg.bn_decay,
                                 dtype)
        self.last_dense = Dense(f * cfg.embedding_dim, cfg.num_features,
                                w_std=0.0, dtype=dtype)
        self.eval()  # serving unless put in training, as flax's train=False

    def forward(self, mixed: Optional[torch.Tensor],
                ctx_a: Optional[torch.Tensor] = None,
                ctx_b: Optional[torch.Tensor] = None,
                emb_a: Optional[torch.Tensor] = None,
                emb_b: Optional[torch.Tensor] = None,
                embed_noise: Optional[torch.Generator] = None,
                noise_rows: Optional[Tuple[int, int]] = None):
        """``mixed`` [B, W, F] windows; either the context spectrograms
        ``ctx_a``/``ctx_b`` [B, C, F] or their precomputed 512-d embeddings
        ``emb_a``/``emb_b``.  With ``mixed=None`` it only encodes the
        contexts and returns (emb_a, emb_b).

        The shared context tower runs on ``ctx_a`` first and ``ctx_b``
        second, so in training its BatchNorms move their population
        statistics twice, in that order.  In training with
        ``cfg.ctx_embed_noise > 0`` and a generator ``embed_noise``, each
        embedding gets Gaussian noise of that size times its RMS.  Under
        data parallelism ``noise_rows`` = (first row, global rows) says
        where this rank's rows sit in the global batch: the noise is drawn
        for the global batch and this rank keeps its rows, so that the
        draws do not depend on the number of ranks."""
        if emb_a is None:
            emb_a = self.embedding(ctx_a)
        if emb_b is None:
            emb_b = self.embedding(ctx_b)
        sigma = self.cfg.ctx_embed_noise
        if self.training and sigma > 0.0 and embed_noise is not None:
            emb_a = _jitter(emb_a, sigma, embed_noise, noise_rows)
            emb_b = _jitter(emb_b, sigma, embed_noise, noise_rows)
        if mixed is None:
            return emb_a, emb_b
        out = mixed[:, None]
        if self.freq_pad:
            out = F.pad(out, (0, self.freq_pad - out.shape[3]))
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i in range(self.num_blocks):
            block = getattr(self, f"resblock{i + 1}")
            if remat:
                # the backward pass runs the block again: its BatchNorms
                # keep the first forward's update of their statistics
                out = checkpoint(block, out, emb_a, emb_b,
                                 use_reentrant=False,
                                 context_fn=lambda b=block: (
                                     contextlib.nullcontext(),
                                     frozen_stats(b)))
            else:
                out = block(out, emb_a, emb_b)
        if self.freq_pad:
            out = out[..., :self.freq_out]
        out = F.relu(self.last_bn(self.last_conv(out)))   # [B, C, 1, F']
        # flatten as NHWC [B, 1, F', C] -> [B, F' * C], frequency-major,
        # which is the row order of last_dense/w
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
        return self.last_dense(out).to(torch.float32)

    def enhance_frames(self, mixed: torch.Tensor, ctx_a: torch.Tensor,
                       ctx_b: torch.Tensor) -> torch.Tensor:
        """Denoised central frames for a batch of windows [B, W, F]."""
        res = self(mixed, ctx_a, ctx_b)
        return mixed[:, self.cfg.window_frames // 2, :] + res



def _jitter(e: torch.Tensor, sigma: float, generator: torch.Generator,
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """e + sigma * RMS(e) * N(0, 1), the RMS over the embedding axis; the
    draws of ``rows`` = (first, total) rows, as ``forward`` says."""
    rms = torch.sqrt(torch.mean(e * e, dim=-1, keepdim=True) + 1e-8)
    first, total = rows or (0, e.shape[0])
    z = torch.randn((total,) + tuple(e.shape[1:]), generator=generator,
                    device=generator.device)[first:first + e.shape[0]]
    return e + sigma * rms * to_device(z, e.device).to(e.dtype)


def freq_loss_weights(num_features: int, hi: float = 2.0, lo: float = 1.0,
                      device=None) -> torch.Tensor:
    """linspace(hi -> lo) weights over the frequency bins."""
    w = torch.from_numpy(np.linspace(hi, lo, num_features, dtype=np.float32))
    return w if device is None else to_device(w, device)


def freq_weighted_mse(denoised: torch.Tensor, target: torch.Tensor,
                      weights: Optional[torch.Tensor] = None):
    """(mean loss, per-example loss) of the frequency-weighted MSE."""
    if weights is None:
        weights = freq_loss_weights(denoised.shape[-1],
                                    device=denoised.device)
    se = torch.square(denoised - target)
    example_loss = torch.mean(se * weights, dim=-1)
    return torch.mean(example_loss), example_loss
