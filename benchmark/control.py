"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/control.py --workload <cell> --seeds S [S ...]
        [--control-seeds S [S ...]] [--witness-seeds S [S ...]]
        [--seconds 12]

On the card, in one process: for each seed of ``--seeds`` the program's
reading, as a run takes it (set-up, a short window of ``--seconds`` at
the cell's own load, the comparison); for each seed of
``--control-seeds`` the control's reading, the reference computed in
TF32 (its operands rounded to 10 mantissa bits) put in the program's
place on the same inputs, and for a training cell the fault of half the
batch left out with the mean taken over the rest, planted in the
reference; a training cell's lines carry every step's loss.  For each
seed of ``--witness-seeds`` (a training cell) the reference run in
float64 as well, and the program's numbers and the float32 reference's
against it, each with its worst leaf, and the float32 reference with
cuDNN switched off (other convolution algorithms, the same float32)
against the reference: whether float32's rounding alone reads as high.
One JSON line per seed; the benchmark's own runs do not run this.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import harness, serving  # noqa: E402


def serving_control(run, sample) -> dict:
    """The serving numbers of the TF32 reference against the float32 one
    on the utterances of ``sample``."""
    from benchmark.reference.model import Net, load_variables
    from benchmark.reference.serve import enhance

    tf32 = Net(run.config, load_variables(serving.weights_path(run),
                                          run.device), tf32=True)
    control = []
    for u in sample:
        r = enhance(tf32, u["mixed"], u["ctx_a"], u["ctx_b"], u["pad_to"],
                    run.device)
        control.append(dict(u, denoised=r["denoised"], snr_est=r["snr_est"]))
    return {c["name"]: c["value"] for c in serving.compare(run, control)}


def training_readings(run, state, program: bool, controls: bool,
                      witness: bool) -> dict:
    """The program's numbers (its state freed first), and the TF32
    reference's and the half-batch fault's, each against the float32
    reference, with every step's loss; with ``witness``, the program's
    and the float32 reference's against the float64 reference too."""
    from benchmark.drivers.train import gaps, reference_steps
    from benchmark.reference.model import load_variables
    from benchmark.reference.train import run_steps

    state.pop("keep", None)
    state.pop("call", None)
    serving.release()
    tp = run.workload["traffic_params"]
    variables = load_variables(serving.weights_path(run), run.device)
    steps = reference_steps(run, state["banks"])
    ref = run_steps(run.config, variables, steps, tp["alg"], tp["lr"])
    out = {"reference_losses": ref["losses"]}
    runs = [("program", state["program"], ref)] if program else []
    if controls:
        for name, kw in (("tf32", {"tf32": True}),
                         ("half_batch", {"half": True})):
            runs.append((name, run_steps(run.config, variables, steps,
                                         tp["alg"], tp["lr"], **kw), ref))
    if witness:
        ref64 = run_steps(run.config, variables, steps, tp["alg"], tp["lr"],
                          dtype=torch.float64)
        with torch.backends.cudnn.flags(enabled=False):
            plain = run_steps(run.config, variables, steps, tp["alg"],
                              tp["lr"])
        out["float64_losses"] = ref64["losses"]
        runs += [("program_vs_float64", state["program"], ref64),
                 ("float32_vs_float64", ref, ref64),
                 ("no_cudnn_vs_float32", plain, ref)]
    for name, alt, against in runs:
        out[name] = gaps(alt, against)
        out[name]["losses"] = alt["losses"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=12.0)
    args = p.parse_args(argv)
    every = args.seeds + args.control_seeds + args.witness_seeds
    for seed in sorted(set(every), key=every.index):
        t0 = time.perf_counter()
        run = harness.open_run(args.workload, seed, args.seconds, False)
        run.facts.update(device_kind=torch.cuda.get_device_name(0),
                         dtype=run.config["dtype"])
        driver = harness.load_module("drivers", run.workload["driver"])
        state = driver.setup(run)
        driver.window(state, args.seconds)
        line = {"workload": args.workload, "seed": seed}
        if "program" in state:      # a training cell
            line.update(training_readings(run, state, seed in args.seeds,
                                          seed in args.control_seeds,
                                          seed in args.witness_seeds))
        else:
            if seed in args.seeds:
                line["program"] = {c["name"]: c["value"]
                                   for c in driver.check(state)}
            else:
                state.pop("stream", None)
                state.pop("enh", None)
                serving.release()
            if seed in args.control_seeds:
                line["control_tf32"] = serving_control(
                    run, serving.sample(run, state["done"]))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del state
        serving.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
