"""Interactive serving: ``Enhancer.enhance`` on one utterance per call, as
the command line serves one file, without its process start.

Traffic (``traffic_params``): one client in a closed loop.  Lengths are
the ``strata`` quantiles of a clipped log-normal distribution; every
block of ``strata`` calls holds each of them once, in an order drawn from
the seed, so that any number of whole blocks is the same work for every
seed.  ``users`` take turns, each with its own pair of noise contexts, so
that after warm-up the engine's context cache always hits.  Set-up warms
every length bucket the traffic can reach.  A call's latency runs from
the call into the engine to the host holding its output arrays; the
window closes when the first call completes after ``--seconds``.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from benchmark import serving, traffic
from benchmark.trace import Trace


def setup(run):
    tp, sr = run.workload["traffic_params"], run.config["sample_rate"]
    enh = serving.make_enhancer(run)
    g = traffic.generator(run.seed, 0, run.device)
    rng = np.random.default_rng([run.seed, 0])
    pairs = serving.contexts(run, g, rng, tp["users"])
    lengths = traffic.quantile_lengths(tp["strata"], sample_rate=sr, **tp["length_s"])
    order = np.concatenate([rng.permutation(len(lengths))
                            for _ in range(tp["blocks"])])
    calls = []
    for user, pair in enumerate(pairs):
        mine = order[user::len(pairs)]
        for i, m in zip(range(user, len(order), len(pairs)),
                        serving.mixtures(run, g, rng, lengths[mine], pair)):
            calls.append((i, {"mixed": m, "ctx_a": pair[0][0],
                              "ctx_b": pair[1][0]}))
    calls = [c for _, c in sorted(calls, key=lambda ic: ic[0])]
    # every bucket the lengths reach, with every user's contexts
    lo, hi = int(lengths[0]), int(lengths[-1])
    buckets = sorted({serving.bucket(run, [n]) for n in range(lo, hi + 1, 160)})
    warm = traffic.speech(g, buckets, sr)
    for k, (n, w) in enumerate(zip(buckets, warm)):
        pair = pairs[k % len(pairs)]
        call = lambda w=w, pair=pair: enh.enhance(w, pair[0][0], pair[1][0])  # noqa: E731
        if k == len(buckets) - 1:
            serving.flop_report(run, call, serving.frames(run, n))
        else:
            call()
    for pair in pairs[len(buckets):]:
        enh.enhance(warm[0], pair[0][0], pair[1][0])
    serving.sync(run)
    return {"run": run, "enh": enh, "calls": calls, "next": 0}


def _call(state):
    u = state["calls"][state["next"] % len(state["calls"])]
    state["next"] += 1
    t = time.perf_counter()
    out = state["enh"].enhance(u["mixed"], u["ctx_a"], u["ctx_b"])
    return u, out, time.perf_counter() - t


def window(state, seconds):
    run = state["run"]
    done, lat = [], []
    t0 = time.perf_counter()
    while True:
        u, out, dt = _call(state)
        lat.append(dt)
        done.append(dict(u, pad_to=serving.bucket(run, [len(u["mixed"])]),
                         denoised=out["denoised"],
                         snr_est=float(out["snr_est"])))
        if time.perf_counter() - t0 >= seconds:
            break
    state["done"] = done
    failed = sum(not serving.well_formed(run, u) for u in done)
    p95 = statistics.quantiles(lat, n=100)[94] if len(lat) > 1 else lat[0]
    print(f"window: {len(lat)} calls, median {1e3 * statistics.median(lat):.3f}"
          f" ms, p95 {1e3 * p95:.3f} ms, {sum(x > p95 for x in lat)} beyond",
          file=sys.stderr, flush=True)
    return {"metrics": {"call_p95_ms": 1e3 * p95},
            "attempted": len(done), "failed": failed}


def trace(state):
    """The calls of the next whole block of ``strata`` calls (every length
    once, so every seed traces the same work), traced."""
    run = state["run"]
    block = run.workload["traffic_params"]["strata"]
    state["next"] = -(-state["next"] // block) * block
    tr = Trace()
    tr.start()
    for _ in range(block):
        with tr.span("enhance: one call"):
            _call(state)
    tr.stop()
    run.facts.update(traced_calls=block)
    return tr


def check(state):
    run = state["run"]
    del state["enh"]
    serving.release()
    return serving.compare(run, serving.sample(run, state["done"]))

