"""Dataset manifests: wav trees as train/valid/test path lists, the port
of ``nhans_tpu/data/manifest.py`` (numpy-free, a copy).

Manifests are JSON; the reference's pickled lists are read as well.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List


def _walk_wavs(folder: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(folder):
        for filename in files:
            if filename.endswith(".wav"):
                out.append(os.path.join(root, filename))
    return sorted(out)


def create_seeds(wav_dir: str, fmt: str = "json") -> dict:
    """Build {train,valid,test} manifests from ``wav_dir/{train,valid,test}``.  Writes
    ``wav_dir/{split}.json`` (or legacy ``.pkl``) and returns the lists."""
    splits = {}
    for split in ("train", "valid", "test"):
        paths = _walk_wavs(os.path.join(wav_dir, split))
        splits[split] = paths
        if fmt == "json":
            with open(os.path.join(wav_dir, f"{split}.json"), "w") as f:
                json.dump(paths, f, indent=0)
        else:
            with open(os.path.join(wav_dir, f"{split}.pkl"), "wb") as f:
                pickle.dump(paths, f)
    return splits


def create_speech_seeds(speech_wav_dir: str, fmt: str = "json") -> dict:
    return create_seeds(speech_wav_dir, fmt)


def create_noise_seeds(noise_wav_dir: str, fmt: str = "json") -> dict:
    return create_seeds(noise_wav_dir, fmt)


def load_seeds(wav_dir: str, split: str) -> List[str]:
    """Load a manifest; prefers JSON, falls back to the reference's
    pickle format."""
    jpath = os.path.join(wav_dir, f"{split}.json")
    if os.path.exists(jpath):
        with open(jpath) as f:
            return list(json.load(f))
    ppath = os.path.join(wav_dir, f"{split}.pkl")
    if os.path.exists(ppath):
        with open(ppath, "rb") as f:
            items = pickle.load(f)
        return [x.decode() if isinstance(x, bytes) else str(x) for x in items]
    raise FileNotFoundError(
        f"no manifest ({split}.json or {split}.pkl) under {wav_dir}; "
        "run python -m nhans_tpu_torch.cli.seeds first")


def create_seeds_from_split_lists(split_dir: str, corpus_root: str,
                                  out_dir: str, extension: str = ".wav",
                                  fmt: str = "json") -> dict:
    """Build manifests from the reference's SPL reproduction split lists
    (DEMO_N-HANS/SPL_Selective_Noise_Suppression/Reproduction_TrainTest_
    Split/{Librispeech,AudioSet}_DataSplit/{train,valid,test}.txt — plain
    utterance IDs, one per line).

    IDs are resolved against ``corpus_root`` by filename stem: we index
    every ``*.wav`` under the root once and match ``<id>.wav``.  Unmatched
    IDs are reported (the corpora themselves are not distributed with the
    reference).
    """
    index = {}
    for root, _dirs, files in os.walk(corpus_root):
        for f in files:
            if f.endswith(extension):
                index[os.path.splitext(f)[0]] = os.path.join(root, f)
    os.makedirs(out_dir, exist_ok=True)
    out, missing = {}, {}
    for split in ("train", "valid", "test"):
        txt = os.path.join(split_dir, f"{split}.txt")
        if not os.path.exists(txt):
            continue
        with open(txt) as f:
            ids = [line.strip() for line in f if line.strip()]
        paths = [index[i] for i in ids if i in index]
        missing[split] = [i for i in ids if i not in index]
        out[split] = paths
        target = os.path.join(out_dir, f"{split}.{ 'json' if fmt=='json' else 'pkl'}")
        if fmt == "json":
            with open(target, "w") as f:
                json.dump(paths, f, indent=0)
        else:
            with open(target, "wb") as f:
                pickle.dump(paths, f)
    for split, miss in missing.items():
        if miss:
            print(f"WARNING: {split}: {len(miss)} ids not found under "
                  f"{corpus_root} (e.g. {miss[:3]})")
    return out
