"""Folder serving: ``Enhancer.enhance_stream`` fed with a folder's batches,
as the denoiser's command line serves ``--input <dir>``.

Traffic (``traffic_params``): folders of ``files`` utterances whose
lengths are the quantiles of a clipped log-normal distribution, served
in consecutive batches of ``batch`` in the name order that ``deal_seed``
draws (``traffic.name_order_batches``), so that every seed serves the
same sequence of batches; each folder has its own pair of noise
contexts, which every file of it shares.  A closed loop keeps
``in_flight`` batches on the card, folder after folder.  The window
closes when the first batch completes after ``--seconds``; the rate is
the audio of every batch completed in it over its whole time.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from benchmark import flops, serving, traffic
from benchmark.trace import Trace


def setup(run):
    tp, sr = run.workload["traffic_params"], run.config["sample_rate"]
    enh = serving.make_enhancer(run)
    lengths = traffic.quantile_lengths(tp["files"], sample_rate=sr, **tp["length_s"])
    folders = []
    for f in range(tp["folders"]):
        g = traffic.generator(run.seed, f, run.device)
        rng = np.random.default_rng([run.seed, f])
        pair = serving.contexts(run, g, rng, 1)[0]
        mixed = serving.mixtures(run, g, rng, lengths, pair)
        for b in traffic.name_order_batches(rng, tp["files"], tp["batch"],
                                            tp["deal_seed"]):
            folders.append([{"mixed": mixed[i], "ctx_a": pair[0][0],
                             "ctx_b": pair[1][0]} for i in b])
    # one warm batch: the engine's first call builds its cuDNN plans and
    # fills the allocator's pool; later shapes cost no more (see PERF.md)
    g = traffic.generator(run.seed, 1 << 20, run.device)
    warm_len = [int(tp["warmup_s"] * sr)] * tp["batch"]
    pair = folders[0][0]["ctx_a"], folders[0][0]["ctx_b"]
    warm = ([traffic.snr_mix(np.random.default_rng(run.seed), v,
                                     [pair[1]], tp["snr_db"])
             for v in traffic.speech(g, warm_len, sr)],
            [pair[0]] * tp["batch"], [pair[1]] * tp["batch"])
    serving.flop_report(run, lambda: enh.enhance_batch(*warm),
                        tp["batch"] * serving.frames(run, warm_len[0]))
    serving.sync(run)
    run.facts.update(window_flops=flops.window_flops(run.config))
    return {"run": run, "enh": enh, "batches": folders}


def _stream(state):
    """The endless closed loop: (batch, its results) in order."""
    batches = itertools.cycle(state["batches"])
    pending, fed = [], state.setdefault("fed", [])

    def feed():
        for b in batches:
            pending.append(b)
            fed.append(b)
            yield ([u["mixed"] for u in b], [u["ctx_a"] for u in b],
                   [u["ctx_b"] for u in b])

    depth = state["run"].workload["traffic_params"]["in_flight"]
    for out in state["enh"].enhance_stream(feed(), depth=depth):
        yield pending.pop(0), out


def window(state, seconds):
    run = state["run"]
    sr = run.config["sample_rate"]
    stream = _stream(state)
    done, audio, windows = [], 0.0, 0
    t0 = time.perf_counter()
    for batch, out in stream:
        pad_to = serving.bucket(run, [len(u["mixed"]) for u in batch])
        for i, u in enumerate(batch):
            done.append(dict(u, pad_to=pad_to, denoised=out["denoised"][i],
                             snr_est=float(out["snr_est"][i])))
            audio += len(u["mixed"]) / sr
            windows += serving.frames(run, len(u["mixed"]))
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    state.update(stream=stream, done=done)
    run.facts.update(window_s=elapsed, real_windows=windows)
    failed = sum(not serving.well_formed(run, u) for u in done)
    return {"metrics": {"audio_s_per_s": audio / elapsed},
            "attempted": len(done), "failed": failed}


def trace(state):
    """``trace.batches`` more batches of the same stream, traced.  The
    card is idle when the trace starts, so the batches dispatched inside
    it are the ones it holds whole; the spectrogram's useful bytes are
    those of their mixtures (a folder's context pair, encoded once, is
    left out)."""
    run = state["run"]
    c = run.config
    count = run.workload["trace"]["batches"]
    tr = Trace()
    tr.start()
    first = len(state["fed"])
    for _ in range(count):
        with tr.span("enhance_stream: dispatch the next batch, read back "
                     "the oldest"):
            next(state["stream"])
    tr.stop()
    spec = 0
    for batch in state["fed"][first:]:
        for u in batch:
            n = serving.trimmed(run, len(u["mixed"]))
            spec += flops.spectrogram_bytes(n, serving.frames(run, n),
                                            c["num_bins"], with_reim=True)
    run.facts.update(traced_batches=len(state["fed"]) - first,
                     traced_spec_bytes=spec)
    return tr


def check(state):
    run = state["run"]
    state.pop("stream").close()
    del state["enh"]
    serving.release()
    return serving.compare(run, serving.sample(run, state["done"]))
