"""Banked training: the step of ``train/step.py::make_train_step(banked=
True)`` on a corpus resident on the card, as the trainer drives it.

Traffic (``traffic_params``): ``rows`` seeded speech rows (and as many
noise rows for a task that mixes two noises) of ``length_s`` seconds,
evenly spread and dealt in a seeded order, in int16 banks of the
configuration's ``max_samples``; each step takes ``utterances`` rows x
``slices_per_step`` crops.  The optimizer is ``alg`` at ``lr`` and
``mom``, from the configuration's shipped weights, so that every layer's
gradient is nonzero from the first step.  Each step's index triples and
random draws are a function of (seed, step), made on the host and sent
as the trainer sends them.  Set-up drives the first ``check.steps`` steps
through the window's own call, on rows that all differ, and keeps what
the comparison reads, then one more under torch's FLOP counter; the
window takes the steps after them, and ends in a read-back of the last
loss.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from benchmark import flops, serving, traffic
from benchmark.trace import Trace


def _config(run):
    tp = run.workload["traffic_params"]
    cfg = serving.port_config(run.config)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, alg=tp["alg"], lr=tp["lr"], mom=tp["mom"],
        train_mb=tp["utterances"] * run.config["slices_per_step"]))


def make_banks(run):
    """The banks, on the run's device, and their row count."""
    tp, c = run.workload["traffic_params"], run.config
    sr, L = c["sample_rate"], c["max_samples"]
    lo, hi = tp["length_s"]
    rng = np.random.default_rng([run.seed, 1])
    lengths = rng.permutation(np.linspace(lo * sr, hi * sr, tp["rows"])
                              .astype(np.int64))
    g = traffic.generator(run.seed, 1, run.device)
    banks = {}
    kinds = [("speech", traffic.speech_rows)]
    if c["two_noise_mixing"]:
        kinds.append(("noise", traffic.noise_rows))
    for name, make in kinds:
        rows = torch.zeros((tp["rows"], L), device=run.device)
        made = make(g, lengths, sr)
        rows[:, :made.shape[1]] = made
        banks[name] = rows.to(torch.int16)
        banks[f"{name}_len"] = torch.as_tensor(lengths, dtype=torch.int32,
                                               device=run.device)
        banks[f"{name}_peak"] = rows.abs().amax(dim=1)
    if not c["two_noise_mixing"]:
        for k in ("", "_len", "_peak"):
            banks[f"noise{k}"] = banks[f"speech{k}"]
    return banks


def step_inputs(run, t: int):
    """Step ``t``'s index triples and draws, on the host.  The first
    ``check.steps`` steps take rows that all differ, and each interfering
    or noise row differs from its clean row."""
    tp = run.workload["traffic_params"]
    B, K, n = tp["utterances"], run.config["slices_per_step"], tp["rows"]
    first = run.workload["check"]["steps"]
    rng = np.random.default_rng([run.seed, 2, t])
    if t < first:
        perm = np.random.default_rng([run.seed, 3]).permutation(n)
        ci = perm[t * B:(t + 1) * B]
    else:
        ci = rng.integers(n, size=B)
    ai = (ci + 1 + rng.integers(n - 1, size=B)) % n
    bi = (ci + 1 + rng.integers(n - 1, size=B)) % n
    n_snr = len(run.config["snr_set"])
    idx = {k: torch.from_numpy(v.astype(np.int32))
           for k, v in (("clean_idx", ci), ("a_idx", ai), ("b_idx", bi))}
    draws = {"snr_a": torch.from_numpy(rng.integers(n_snr, size=B)),
             "snr_b": torch.from_numpy(rng.integers(n_snr, size=B)),
             "u_win": torch.from_numpy(rng.random((B, K), np.float32)),
             "u_ctx_a": torch.from_numpy(rng.random((B, K), np.float32)),
             "u_ctx_b": torch.from_numpy(rng.random((B, K), np.float32))}
    return idx, draws


def setup(run):
    from nhans_tpu_torch.compat.weights import load_npz
    from nhans_tpu_torch.nn.model import NHANSNet
    from nhans_tpu_torch.train.step import (make_train_step, make_tx,
                                            state_of, step_generator)
    from nhans_tpu_torch.utils.device import to_device

    cfg = _config(run)
    model = NHANSNet(cfg.model)
    model.load_state_dict(load_npz(serving.weights_path(run)))
    model = model.to(run.device)
    tx = make_tx(cfg)
    state = state_of(model, tx)
    step = make_train_step(cfg, model, tx, banked=True)
    banks = make_banks(run)
    dev = torch.device(run.device)

    def call(t):
        idx, draws = step_inputs(run, t)
        idx = {k: to_device(v, dev) for k, v in idx.items()}
        return step(state, banks, idx, step_generator(run.seed, t), draws)

    # the compared steps, run as the window runs them; the first warms up
    start = {k: p.detach().clone() for k, p in state.params.items()}
    losses = [call(0)["loss"]]
    tp = run.workload["traffic_params"]
    if tp["alg"] == "sgd":
        grads = {k: torch.linalg.vector_norm(p.detach() - start[k]) / tp["lr"]
                 for k, p in state.params.items()}
    else:    # the first moment after one step is (1 - 0.9) times it
        grads = {k: torch.linalg.vector_norm(m) / 0.1
                 for k, m in state.opt_state["mu"].items()}
    compared = run.workload["check"]["steps"]
    for t in range(1, compared):
        losses.append(call(t)["loss"])
    change = {k: torch.linalg.vector_norm(p.detach() - start[k])
              for k, p in state.params.items()}
    program = {"losses": [float(x) for x in losses],
               "grad_norms": {k: float(v) for k, v in grads.items()},
               "change_norms": {k: float(v) for k, v in change.items()}}
    del start
    # the program's own count, on the step after the compared ones
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        call(compared)
    examples = tp["utterances"] * run.config["slices_per_step"]
    mine = flops.train_step_flops(run.config, examples)
    port = counter.get_total_flops()
    print(f"flops: yardstick {mine} per step of {examples} windows, "
          f"program's FlopCounterMode {port}, ratio {port / mine:.6f}",
          file=sys.stderr, flush=True)
    serving.sync(run)
    run.facts.update(step_flops=mine)
    return {"run": run, "call": call, "program": program, "banks": banks,
            "next": compared + 1, "keep": (model, state)}


def window(state, seconds):
    run = state["run"]
    t0 = time.perf_counter()
    steps = 0
    while True:
        out = state["call"](state["next"])
        state["next"] += 1
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    loss = float(out["loss"])          # waits for the last step
    elapsed = time.perf_counter() - t0
    examples = run.workload["traffic_params"]["utterances"] * \
        run.config["slices_per_step"]
    run.facts.update(step_s=elapsed / steps)
    print(f"window: {steps} steps, {1e3 * elapsed / steps:.3f} ms a step, "
          f"last loss {loss!r}", file=sys.stderr, flush=True)
    return {"metrics": {"train_windows_per_s": steps * examples / elapsed},
            "attempted": steps, "failed": int(not np.isfinite(loss))}


def trace(state):
    """``trace.steps`` more steps, traced."""
    run = state["run"]
    count = run.workload["trace"]["steps"]
    c = run.config
    tr = Trace()
    tr.start()
    for _ in range(count):
        with tr.span("train step: enqueue"):
            state["call"](state["next"])
        state["next"] += 1
    tr.stop()
    B = run.workload["traffic_params"]["utterances"]
    L = c["max_samples"]
    F = 1 + (L - c["frame_length"]) // c["frame_step"]
    run.facts.update(traced_steps=count, traced_spec_bytes=count * 4 *
                     flops.spectrogram_bytes(B * L, B * F, c["num_bins"],
                                             with_reim=False))
    return tr


def check(state):
    from benchmark.reference.model import load_variables
    from benchmark.reference.train import run_steps

    run = state["run"]
    tp = run.workload["traffic_params"]
    del state["keep"], state["call"]
    serving.release()
    ref = run_steps(run.config, load_variables(serving.weights_path(run),
                                               run.device),
                    reference_steps(run, state["banks"]), tp["alg"], tp["lr"])
    return compare(run, state["program"], ref)


def reference_steps(run, banks):
    """The compared steps' rows and draws, for the reference."""
    out = []
    for t in range(run.workload["check"]["steps"]):
        idx, draws = step_inputs(run, t)
        ci, ai, bi = (idx[k].to(run.device, torch.int64)
                      for k in ("clean_idx", "a_idx", "b_idx"))
        rows = {"clean": banks["speech"][ci], "noise_a": banks["noise"][ai],
                "noise_b": banks["noise"][bi],
                "clean_len": banks["speech_len"][ci],
                "len_a": banks["noise_len"][ai], "len_b": banks["noise_len"][bi],
                "peaks": torch.stack([banks["speech_peak"][ci],
                                      banks["noise_peak"][ai],
                                      banks["noise_peak"][bi]], dim=1)}
        out.append({"rows": rows,
                    "draws": {k: v.to(run.device) for k, v in draws.items()}})
    return out


def gaps(program: dict, ref: dict) -> dict:
    """The first step's loss and the worst step's, relative; each leaf's
    first gradient norm and its change after the steps, by the worst leaf,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger, with the name of that leaf; and the medians of
    the leaves' gradient and change gaps, which round-off in a few leaves
    leaves steady.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    losses = [abs(p - r) / abs(r)
              for p, r in zip(program["losses"], ref["losses"])]
    if len(program["losses"]) != len(ref["losses"]):
        losses = [float("inf")]

    def each(prog, refs, keep):
        """(worst gap, its leaf, median gap) over the leaves ``keep`` takes."""
        med = float(np.median([refs[k] for k in refs]))
        found = [(abs(prog.get(k, float("inf")) - refs[k]) / max(refs[k], med),
                  k) for k in refs if keep(k)]
        if not found:
            return float("inf"), None, float("inf")
        return max(found) + (float(np.median([g for g, _ in found])),)

    g_ref = ref["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    name = {k.replace("/", "."): k for k in g_ref}

    def by_ref_name(norms):
        return {name[k.replace("/", ".")]: v for k, v in norms.items()
                if k.replace("/", ".") in name}

    grad, grad_leaf, median_grad = each(by_ref_name(program["grad_norms"]),
                                        g_ref, lambda k: True)
    change, change_leaf, median_change = each(
        by_ref_name(program["change_norms"]), ref["change_norms"],
        lambda k: g_ref[k] >= 1e-3 * g_med)
    return {"first_loss_gap": losses[0], "loss_gap": max(losses),
            "grad_gap": grad, "change_gap": change,
            "median_grad_gap": median_grad, "median_change_gap": median_change,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf}


def compare(run, program: dict, ref: dict):
    """Of ``gaps``, the numbers the workload's ``check.limits`` names, each
    beside its limit."""
    values = gaps(program, ref)
    # a cell compares the numbers its workload gives limits for
    return [{"name": k, "value": values[k], "limit": v}
            for k, v in run.workload["check"]["limits"].items()]
