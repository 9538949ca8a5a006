"""Run one cell of the benchmark of ``nhans_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  A new
process loads the cell's files (``harness.py``), sets up the program and
its traffic from the seed and warms up every shape the traffic uses
(``setup_s``, from process start), measures for ``--seconds`` seconds,
then compares what the window produced with the plain reference under
``benchmark/reference/``.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read from
a profiler trace of a short steady stretch after the window), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared
number beside its limit, which also end standard error.  Without a card,
or with fewer than the cell asks for, it exits 3 and prints no result; on
any other failure it exits 1 and prints none.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(run, driver, t0: float) -> dict:
    """Set up, measure, compare; the result line's object."""
    import torch

    from benchmark import harness
    from benchmark.trace import breakdown, device_busy

    cuda = torch.device(run.device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    run.facts.update(device_kind=kind, dtype=run.config["dtype"])
    state = driver.setup(run)
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = driver.window(state, run.seconds)
    trace = driver.trace(state) if run.trace else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    checks = driver.check(state)
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": int(run.entry["chips"]), "memory_peak_bytes": peak}
    if run.trace:
        metrics = harness.read_per_layer(run, trace)
        device.update(device_busy(trace))
    else:
        values = dict(out["metrics"], setup_s=setup_s,
                      peak_mem_gib=peak / 2 ** 30)
        metrics = {}
        for m in run.metrics("end_to_end"):
            if m["name"] not in values:
                raise harness.BenchError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    result = {"correct": harness.judged(checks) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = breakdown(trace)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import torch

        from benchmark import harness

        run = harness.open_run(args.workload, args.seed, args.seconds,
                               bool(args.trace))
        need = int(run.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"error: {args.workload} needs {need} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}",
                  file=sys.stderr)
            return 3
        driver = harness.load_module("drivers", run.workload["driver"])
        result = execute(run, driver, T0)
    except Exception:  # noqa: BLE001 - the process's boundary: no result
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
