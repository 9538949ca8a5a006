"""The N-HANS conditional ResNet in plain PyTorch, the benchmark's yardstick.

A functional forward pass over the flat flax variables of a ``.npz``
checkpoint (``params/...`` and ``batch_stats/...``, convolution kernels
HWIO), written from the published description: TF-SAME padded
convolutions, BatchNorm with eps 1e-3, the context tower with its global
average pool, and the main tower whose convolutions are conditioned by
projections of both context embeddings and by time- and frequency-position
MLPs, then the time-collapsing head.  Float32 with TF32 off; with
``tf32=True`` every convolution and product rounds its operands to TF32's
10-bit mantissa first, which is the control of the comparison.

It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def load_variables(path: str, device) -> Params:
    """The checkpoint's arrays as float32 tensors on ``device``, by name."""
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
                for k in z.files}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest; gradients
    pass through as they are."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


class Net:
    """The network over ``variables`` (``load_variables``).  ``train``:
    BatchNorm takes the batch's biased moments (the population statistics
    are not moved: a training comparison reads losses and parameters
    only).  ``params`` maps a leaf name (``resblock1/conv1/w``) to a
    tensor; pass tensors that require grad to differentiate."""

    def __init__(self, cfg: dict, variables: Params, train: bool = False,
                 tf32: bool = False):
        self.cfg = cfg
        self.params = {k[len("params/"):]: v for k, v in variables.items()
                       if k.startswith("params/")}
        self.stats = {k[len("batch_stats/"):]: v
                      for k, v in variables.items()
                      if k.startswith("batch_stats/")}
        self.train = train
        self.tf32 = tf32

    # -- layers ---------------------------------------------------------
    def _op(self, x):
        return round_tf32(x) if self.tf32 else x

    def dense(self, name: str, x, bias: bool = True):
        y = torch.matmul(self._op(x), self._op(self.params[f"{name}/w"]))
        return y + self.params[f"{name}/b"] if bias else y

    def conv(self, name: str, x, stride, padding: str = "SAME",
             bias: bool = True):
        w = self.params[f"{name}/w"]                  # HWIO
        kh, kw = w.shape[0], w.shape[1]
        if padding == "SAME":
            pads = []
            for n, k, s in ((x.shape[3], kw, stride[1]),
                            (x.shape[2], kh, stride[0])):
                total = max((math.ceil(n / s) - 1) * s + k - n, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        y = F.conv2d(self._op(x), self._op(w.permute(3, 2, 0, 1)),
                     stride=tuple(stride))
        if bias:
            y = y + self.params[f"{name}/b"].view(1, -1, 1, 1)
        return y

    def bn(self, name: str, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.train:
            dims = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(dim=dims)
            var = (x * x).mean(dim=dims) - mean * mean
        else:
            mean = self.stats[f"{name}/pop_mean"]
            var = self.stats[f"{name}/pop_variance"]
        inv = torch.rsqrt(var + self.cfg["bn_eps"]) * self.params[f"{name}/gamma"]
        return ((x - mean.view(shape)) * inv.view(shape)
                + self.params[f"{name}/beta"].view(shape))

    def positions(self, name: str, n: int, device):
        x = torch.arange(n, dtype=self.params[f"{name}/dense1/w"].dtype,
                         device=device)[:, None]
        x = F.relu(self.bn(f"{name}/bn1", self.dense(f"{name}/dense1", x,
                                                     False)))
        x = F.relu(self.bn(f"{name}/bn2", self.dense(f"{name}/dense2", x,
                                                     False)))
        return self.dense(f"{name}/dense3", x, False)          # [n, C]

    def inject(self, name: str, x, emb_a, emb_b):
        a = self.dense(f"{name}/proj_a", emb_a)[:, :, None, None]
        b = self.dense(f"{name}/proj_b", emb_b)[:, :, None, None]
        t = self.positions(f"{name}/temb", x.shape[2], x.device)
        f = self.positions(f"{name}/femb", x.shape[3], x.device)
        return x + a + b + t.t()[None, :, :, None] + f.t()[None, :, None, :]

    # -- towers ---------------------------------------------------------
    def embed(self, ctx):
        """Context spectrograms [B, C, bins] -> embeddings [B, 512]."""
        x = ctx[:, None]
        cin = 1
        for i, (_, stride, feat) in enumerate(self.cfg["context_blocks"]):
            n = f"embedding/block{i + 1}"
            p1 = F.relu(self.bn(f"{n}/bn1", self.conv(f"{n}/conv1", x, stride,
                                                      bias=False)))
            p1 = self.conv(f"{n}/conv2", p1, (1, 1))
            p2 = self.conv(f"{n}/transform", x, stride) if cin != feat else x
            x = F.relu(self.bn(f"{n}/bn_out", p1 + p2))
            cin = feat
        return x.mean(dim=(2, 3))

    def residual(self, windows, emb_a, emb_b):
        """Windows [N, W, bins] and their rows' embeddings [N, 512] -> the
        predicted residual of each central frame [N, bins]."""
        x = windows[:, None]
        cin = 1
        for i, (_, s, feat) in enumerate(self.cfg["main_blocks"]):
            n = f"resblock{i + 1}"
            p1 = self.inject(f"{n}/inject1",
                             self.conv(f"{n}/conv1", x, (s, s), bias=False),
                             emb_a, emb_b)
            p1 = F.relu(self.bn(f"{n}/bn1", p1))
            p1 = self.inject(f"{n}/inject2", self.conv(f"{n}/conv2", p1,
                                                       (1, 1)), emb_a, emb_b)
            p2 = self.conv(f"{n}/transform", x, (s, s)) if cin != feat else x
            x = F.relu(self.bn(f"{n}/bn_out", p1 + p2))
            cin = feat
        x = F.relu(self.bn("last_bn", self.conv("last_conv", x, (1, 1),
                                                "VALID", bias=False)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense("last_dense", x)


def tower_windows(net: Net, logmag: torch.Tensor, count: int, emb_a, emb_b,
                  block: int = 1024):
    """Residuals [count, bins] of the first ``count`` frames of one
    utterance's log-magnitude [F, bins]: frame t's window holds frames
    t - 17 .. t + 17, zeros outside [0, F).  Computed ``block`` windows at
    a time so that it fits."""
    W = net.cfg["window_frames"]
    before, after = (W + 1) // 2 - 1, W // 2
    padded = F.pad(logmag, (0, 0, before, after))
    out = []
    k = torch.arange(W, device=logmag.device)
    for s in range(0, count, block):
        t = torch.arange(s, min(s + block, count), device=logmag.device)
        win = padded[t[:, None] + k[None, :]]
        n = len(t)
        out.append(net.residual(win, emb_a.expand(n, -1),
                                emb_b.expand(n, -1)))
    return torch.cat(out)
