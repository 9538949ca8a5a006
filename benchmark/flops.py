"""Operations and bytes of N-HANS work, from the configuration's shapes.

Counted from the model as published, at the native frequency width and
the traffic's real lengths, never from the shapes a program happens to
run: padding that a program stops computing, a wider padded tower or
another convolution algorithm leaves these counts as they are.  Two
floating-point operations per multiply-add of every convolution and
dense layer; BatchNorm, activations and additions are not counted, nor
the position MLPs, which run once per call whatever its batch (0.02 % of
a window's count).
"""

from __future__ import annotations

import math


def _same(n: int, s: int) -> int:
    return math.ceil(n / s)


def window_flops(cfg: dict) -> int:
    """One window through the main tower and its head, the two context
    embeddings given: the residual of one frame."""
    T, F = cfg["window_frames"], cfg["num_bins"]
    emb = cfg["context_blocks"][-1][2]          # the context embedding
    cin, total = 1, 0
    for k, s, c in cfg["main_blocks"]:
        T, F = _same(T, s), _same(F, s)
        total += 2 * T * F * c * cin * k * k          # conv1
        total += 2 * T * F * c * c * k * k            # conv2
        if cin != c:
            total += 2 * T * F * c * cin              # 1x1 shortcut
        total += 4 * 2 * emb * c                      # two injects x (a, b)
        cin = c
    head = cfg["embedding_dim"]
    total += 2 * F * head * cin * T                   # time-collapsing conv
    total += 2 * F * head * cfg["num_bins"]           # dense head
    return total


def context_flops(cfg: dict) -> int:
    """One context spectrogram through the context tower."""
    T, F = cfg["context_frames"], cfg["num_bins"]
    cin, total = 1, 0
    for (kh, kw), (sh, sw), c in cfg["context_blocks"]:
        T, F = _same(T, sh), _same(F, sw)
        total += 2 * T * F * c * cin * kh * kw
        total += 2 * T * F * c * c * kh * kw
        if cin != c:
            total += 2 * T * F * c * cin
        cin = c
    return total


def _first_layers(cfg: dict) -> int:
    """Forward operations of the layers whose input is the data itself
    (the first block's convolution and shortcut, in both towers per
    example): their backward pass needs no input gradient."""
    c = cfg["main_blocks"][0][2]
    s = cfg["main_blocks"][0][1]
    k = cfg["main_blocks"][0][0]
    T, F = _same(cfg["window_frames"], s), _same(cfg["num_bins"], s)
    main = 2 * T * F * c * k * k + 2 * T * F * c
    (kh, kw), (sh, sw), cc = cfg["context_blocks"][0]
    T, F = _same(cfg["context_frames"], sh), _same(cfg["num_bins"], sw)
    ctx = 2 * T * F * cc * kh * kw + 2 * T * F * cc
    return main + 2 * ctx


def train_step_flops(cfg: dict, examples: int) -> int:
    """One training step of ``examples`` windows, each with its own two
    contexts: the forward pass, and a backward pass of twice its
    operations (input and weight gradients) but for the input gradients
    of the layers that read the data."""
    fwd = examples * (window_flops(cfg) + 2 * context_flops(cfg))
    return 3 * fwd - examples * _first_layers(cfg)


def spectrogram_bytes(samples: int, frames: int, bins: int,
                      with_reim: bool) -> int:
    """Bytes a log-magnitude spectrogram has to move at least: the float32
    samples in once, its float32 outputs out once (log-magnitude, and the
    real and imaginary parts where the caller keeps them)."""
    return 4 * samples + 4 * frames * bins * (3 if with_reim else 1)
