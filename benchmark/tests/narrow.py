"""A narrow copy of a configuration for the CPU tests: the published
geometry (16 kHz, 35-frame windows, 200-frame contexts, 201 bins) with
few channels, random weights written as the shipped checkpoints are, and
cells with a few short files or steps."""

from __future__ import annotations

import copy
import hashlib
import os

import numpy as np
import torch

from benchmark import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name: str, tmp: str, seed: int = 0) -> dict:
    """The configuration ``name`` with 4 to 16 channels and random
    weights in ``tmp``."""
    from nhans_tpu_torch.compat.weights import flat_variables
    from nhans_tpu_torch.nn.model import NHANSNet

    from benchmark.serving import port_config

    cfg = harness.load_json(os.path.join(HERE, "configs", f"{name}.json"))
    cfg["main_blocks"] = [[k, s, c // 16] for k, s, c in
                          cfg["main_blocks"]]
    cfg["context_blocks"] = [[k, s, c // 16] for k, s, c in
                             cfg["context_blocks"]]
    cfg["embedding_dim"] = 16
    model = NHANSNet(port_config(cfg).model)
    g = torch.Generator().manual_seed(seed)
    state = {}
    for k, v in model.state_dict().items():
        z = torch.randn(v.shape, generator=g)
        if k.endswith("pop_variance"):
            state[k] = 1.0 + 0.2 * z.abs()
        elif k.endswith("gamma"):
            state[k] = 1.0 + 0.1 * z
        elif k.endswith(("beta", "pop_mean", ".b")):
            state[k] = 0.1 * z
        else:
            fan_in = max(v[0].numel() if v.ndim == 4 else v.shape[0], 1)
            state[k] = z / np.sqrt(fan_in)
    path = os.path.join(tmp, f"{name}.npz")
    np.savez(path, **flat_variables(state))
    with open(path, "rb") as f:
        cfg["weights"] = path
        cfg["weights_sha256"] = hashlib.sha256(f.read()).hexdigest()
    return cfg


def run(cell: str, tmp: str, seed: int = 1, seconds: float = 0.0,
        workload_edits=None, max_samples: int = 0) -> harness.Run:
    """A CPU Run of ``cell`` on the narrow configuration, its traffic cut
    by ``workload_edits`` (a function of the workload dict), its banks to
    ``max_samples`` where given."""
    bench = harness.load_json(os.path.join(os.path.dirname(HERE),
                                           "BENCHMARK.json"))
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    workload = copy.deepcopy(harness.load_json(
        os.path.join(HERE, "workloads", f"{cell}.json")))
    if workload_edits:
        workload_edits(workload)
    cfg = config(entry["config"], tmp)
    if max_samples:
        cfg["max_samples"] = max_samples
    r = harness.Run(cell, seed, seconds, False, bench, entry, workload, cfg,
                    device="cpu")
    r.facts.update(device_kind="cpu", dtype=cfg["dtype"])
    return r


def small_folder(w: dict) -> None:
    w["traffic_params"].update(files=8, batch=4, folders=1, deal_seed=0,
                               context_s=[2.1, 2.5], warmup_s=1.0,
                               length_s={"median_s": 1.3, "sigma": 0.3,
                                         "lo_s": 1.0, "hi_s": 2.0})
    w["check"]["sample"] = 2


def small_interactive(w: dict) -> None:
    w["traffic_params"].update(users=2, strata=4, blocks=1,
                               context_s=[2.1, 2.5],
                               length_s={"median_s": 1.2, "sigma": 0.2,
                                         "lo_s": 1.0, "hi_s": 1.6})
    w["check"]["sample"] = 2


def small_train(w: dict) -> None:
    w["traffic_params"].update(rows=12, utterances=2, length_s=[2.5, 3.0])
