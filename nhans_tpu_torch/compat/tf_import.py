"""TF checkpoint -> the port's flat flax-named variables: the port of
``nhans_tpu/compat/tf_import.py``.

Maps every variable name of the reference's Saver checkpoints (the
published ``81448_0-1000000`` denoiser and ``81457_2-545000`` separator
bundles) onto the flax names the port's modules carry
(``params/...``, ``batch_stats/...``; ``compat/weights.py``).

Name conventions in the reference graph:

* context tower: ``embedding/noise_resblock{i}_1_{conv1,conv2,transform,
  addition}/...`` where the BN after conv1 reuses the ``_conv1`` scope and
  the output BN lives under ``_addition``,
* main tower: ``resblock{j}_{k}...`` (j=1..4 stages, k=1..2); only the
  channel-changing blocks 1, 3, 5 and 7 have a shortcut conv,
* conditioning: ``..._conv{c}_{noise_pos_emb|noise_neg_emb}`` for the
  denoiser, ``..._{noise_emb|clean_emb}`` for the separator, plus
  ``..._conv{c}_{temb,femb}_dense{1,2,3}`` MLPs whose BatchNorms carry a
  doubled scope (``scope_name + scope_name + '_dense1'``),
* head: ``last_conv`` (+ BN in the same scope) and ``last_dense``.

Shape conventions: TF conv kernels are HWIO and dense kernels [in, out],
as in flax; biases [1, ..., C] and BN tensors [1, 1, 1, C] squeeze to [C].
Each tensor is reshaped by element count into the flax shape (HWIO for a
conv kernel), never into the port's OIHW shape: ``from_flax`` transposes
HWIO to OIHW, where a reshape straight into OIHW would keep every size
and scramble every kernel.  The flax shapes come from the port's own
``NHANSNet`` for the config, built on the meta device (no weights
drawn); ``freq_pad_to`` changes no weight shape.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from nhans_tpu_torch.compat.tf_bundle import TFBundleReader

Path = Tuple[str, ...]


def _bn(m: Dict[str, Tuple[str, Path]], tf_scope: str, fx: Path) -> None:
    m[f"{tf_scope}/beta"] = ("params", fx + ("beta",))
    m[f"{tf_scope}/gamma"] = ("params", fx + ("gamma",))
    m[f"{tf_scope}/pop_mean"] = ("batch_stats", fx + ("pop_mean",))
    m[f"{tf_scope}/pop_variance"] = ("batch_stats", fx + ("pop_variance",))


def tf_name_map(task: str = "denoiser") -> Dict[str, Tuple[str, Path]]:
    """{tf_variable_name: (collection, flax_path)} for every model
    variable."""
    m: Dict[str, Tuple[str, Path]] = {}

    # ---- context-embedding tower (shared)
    for i in range(1, 5):
        tb = f"embedding/noise_resblock{i}_1"
        fx: Path = ("embedding", f"block{i}")
        m[f"{tb}_conv1/w"] = ("params", fx + ("conv1", "w"))
        _bn(m, f"{tb}_conv1", fx + ("bn1",))
        m[f"{tb}_conv2/w"] = ("params", fx + ("conv2", "w"))
        m[f"{tb}_conv2/b"] = ("params", fx + ("conv2", "b"))
        m[f"{tb}_transform/w"] = ("params", fx + ("transform", "w"))
        m[f"{tb}_transform/b"] = ("params", fx + ("transform", "b"))
        _bn(m, f"{tb}_addition", fx + ("bn_out",))

    # ---- main tower
    sfx_a, sfx_b = (("noise_pos_emb", "noise_neg_emb") if task == "denoiser"
                    else ("noise_emb", "clean_emb"))
    for n in range(1, 9):
        j, k = (n + 1) // 2, 2 - (n % 2)
        tb = f"resblock{j}_{k}"
        fx = (f"resblock{n}",)
        m[f"{tb}_conv1/w"] = ("params", fx + ("conv1", "w"))
        _bn(m, f"{tb}_conv1", fx + ("bn1",))
        m[f"{tb}_conv2/w"] = ("params", fx + ("conv2", "w"))
        m[f"{tb}_conv2/b"] = ("params", fx + ("conv2", "b"))
        if n in (1, 3, 5, 7):  # channel-changing blocks have a shortcut conv
            m[f"{tb}_transform/w"] = ("params", fx + ("transform", "w"))
            m[f"{tb}_transform/b"] = ("params", fx + ("transform", "b"))
        _bn(m, f"{tb}_addition", fx + ("bn_out",))
        for ci in (1, 2):
            base = f"{tb}_conv{ci}"
            inj = fx + (f"inject{ci}",)
            m[f"{base}_{sfx_a}/w"] = ("params", inj + ("proj_a", "w"))
            m[f"{base}_{sfx_a}/b"] = ("params", inj + ("proj_a", "b"))
            m[f"{base}_{sfx_b}/w"] = ("params", inj + ("proj_b", "w"))
            m[f"{base}_{sfx_b}/b"] = ("params", inj + ("proj_b", "b"))
            for emb in ("temb", "femb"):
                s = f"{base}_{emb}"
                e = inj + (emb,)
                for d in (1, 2, 3):
                    m[f"{s}_dense{d}/w"] = ("params", e + (f"dense{d}", "w"))
                for d in (1, 2):  # doubled scope of the reference graph
                    _bn(m, f"{s}{s}_dense{d}", e + (f"bn{d}",))

    # ---- head
    m["last_conv/w"] = ("params", ("last_conv", "w"))
    _bn(m, "last_conv", ("last_bn",))
    m["last_dense/w"] = ("params", ("last_dense", "w"))
    m["last_dense/b"] = ("params", ("last_dense", "b"))
    return m


def flax_key(coll: str, path: Path) -> str:
    """The flat key of a map entry: ``<collection>/<path>``."""
    return "/".join((coll,) + tuple(path))


def flax_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """{flat flax key: flax shape} of the port's ``NHANSNet`` for
    ``cfg``: conv kernels HWIO (the port holds OIHW), the rest as the
    module holds them.  Built on the meta device, so nothing is
    allocated or drawn."""
    from nhans_tpu_torch.models import build_model

    with torch.device("meta"):
        model = build_model(cfg)
    shapes = {}
    for coll, named in (("params", model.named_parameters()),
                        ("batch_stats", model.named_buffers())):
        for name, t in named:
            shape = tuple(t.shape)
            if len(shape) == 4:  # OIHW -> HWIO
                shape = (shape[2], shape[3], shape[1], shape[0])
            shapes[f"{coll}/{name.replace('.', '/')}"] = shape
    return shapes


def import_tf_checkpoint(prefix: str, cfg, task: str = "denoiser",
                         strict: bool = True) -> Dict[str, np.ndarray]:
    """The variables of a reference Saver checkpoint as flat float32
    flax-named arrays (conv kernels HWIO), the layout ``from_flax`` and
    ``train/checkpoint.py`` read.

    Every mapped name must be in the bundle with the element count of its
    flax shape; with ``strict`` (the default) a missing or mismatched
    name raises ValueError listing them, otherwise those names are left
    out of the result."""
    reader = TFBundleReader(prefix)
    shapes = flax_shapes(cfg)
    out: Dict[str, np.ndarray] = {}
    missing, mismatched = [], []
    for tf_name, (coll, path) in tf_name_map(task).items():
        key = flax_key(coll, path)
        if tf_name not in reader.entries:
            missing.append(tf_name)
            continue
        value = np.asarray(reader.read(tf_name), np.float32)
        shape = shapes[key]
        if value.size != int(np.prod(shape)):
            mismatched.append((tf_name, value.shape, shape))
            continue
        out[key] = np.ascontiguousarray(value.reshape(shape))
    if strict and (missing or mismatched):
        raise ValueError(f"TF import failed: missing={missing[:5]} "
                         f"({len(missing)} total), mismatched={mismatched[:5]}"
                         f" ({len(mismatched)} total)")
    return out


def check_name_map_against_index(prefix: str, task: str) -> Tuple[list, list]:
    """Compare the static name map with a real .index: returns
    (names_missing_from_ckpt, ckpt_names_not_mapped)."""
    reader = TFBundleReader(prefix)
    ours = set(tf_name_map(task))
    theirs = set(reader.keys())
    return sorted(ours - theirs), sorted(theirs - ours)
