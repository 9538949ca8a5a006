"""Score the port against the reference's golden demo corpus
(``DEMO_N-HANS``), the port of ``tools/validate_demo.py``.

Runs the denoiser/separator over the corpus's example directories (mixed
+ contexts) and reports SI-SDR of the port's output against the shipped
golden ``denoised``/``separated`` wav and, where the example has one,
SI-SDR, STOI and PESQ against its ``target``.  Meaningful once the
published TF weights are imported (``cli.load_denoiser
--tf_checkpoint``); with no ``--checkpoint`` it scores the random
initialisation, the identity baseline.

    python -m nhans_tpu_torch.tools.validate_demo --demo_root DEMO_N-HANS \\
        [--checkpoint ckpt_dir] [--task denoiser] [--limit 3] [--json out]

The serving path is the port's ``Enhancer`` (the CUDA spectrogram kernel
on the card, ``--device cpu`` for the plain version).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def derive_separator_contexts(mixed: np.ndarray, golden: np.ndarray,
                              fs: int = 16000, mode: str = "head2s"):
    """(target_ctx, interference_ctx) for a separation example that
    ships only ``mixed`` + the published model's separated output.

    The published pipeline peak-normalises its outputs by the mixed
    maximum, so the output is first least-squares-projected back onto
    the mixed recording's scale; the interference signal is the residual
    ``mixed - a*golden`` (the reference's own removed.wav convention).

    ``mode``:
      * ``head2s``: both contexts are the FIRST 2 s of their signal.
      * ``residual_full``: derive over the FULL example, then hand the
        model the 2 s window of each signal with MAXIMUM energy (the most
        voice-active stretch), hop 0.25 s.
    """
    L = min(len(mixed), len(golden))
    m2, g2 = mixed[:L], golden[:L]
    a = float(np.dot(m2, g2) / (np.dot(g2, g2) + 1e-9))
    tgt, res = a * g2, m2 - a * g2
    ctx_n = 2 * fs
    if mode == "head2s" or L <= ctx_n:
        return tgt[:ctx_n], res[:ctx_n]

    def best_window(x):
        hop = fs // 4
        starts = range(0, len(x) - ctx_n + 1, hop)
        e = [float(np.dot(x[s:s + ctx_n], x[s:s + ctx_n]))
             for s in starts]
        s = list(starts)[int(np.argmax(e))]
        return x[s:s + ctx_n]

    return best_window(tgt), best_window(res)


def find_examples(root: str, task: str):
    """The example directories of ``task`` under ``root`` that hold a
    ``mixed`` and a golden output wav, with their files by kind token
    (the last ``_``-separated part of the name)."""
    sub = {"denoiser": "denoising",
           "selective": "selective_noise_suppression",
           "separator": "source_separation"}[task]
    base = os.path.join(root, sub)
    out = []
    if not os.path.isdir(base):
        return out
    for ex in sorted(os.listdir(base)):
        d = os.path.join(base, ex)
        if not os.path.isdir(d):
            continue
        files = {f.split("_")[-1].replace(".wav", ""): os.path.join(d, f)
                 for f in os.listdir(d) if f.endswith(".wav")}

        def pick(*keys):
            # EXACT kind-token match: a substring match hijacks the
            # separator probe ("noise" is a substring of "denoised", so
            # the published OUTPUT would become the interference context
            # and derive_separator_contexts would never run)
            for k in keys:
                for name, p in files.items():
                    if name.lower() == k:
                        return p
            return None

        mixed = pick("mixed")
        golden = pick("denoised", "separated")
        target = pick("target")
        pos = pick("posnoise")
        neg = pick("negnoise", "noise")
        if mixed and golden:
            out.append(dict(name=ex, mixed=mixed, golden=golden,
                            target=target, pos=pos, neg=neg))
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m nhans_tpu_torch.tools."
                                     "validate_demo")
    p.add_argument("--demo_root", required=True,
                   help="the DEMO_N-HANS corpus directory")
    p.add_argument("--task", default="denoiser",
                   choices=("denoiser", "selective", "separator"))
    p.add_argument("--checkpoint", default="",
                   help="any checkpoint the serving CLIs take; none "
                        "scores a random initialisation")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--json", default="",
                   help="also write records here for tools/quality_report.py")
    p.add_argument("--ac", action="store_true", default=False,
                   help="also score the --ac energy-compensated output "
                        "(denoised + removed * snr_est/20), reported as "
                        "*_ac keys")
    p.add_argument("--ctx_mode", default="head2s",
                   choices=("head2s", "residual_full"),
                   help="separator-context derivation for example dirs "
                        "that ship only mixed+output (see "
                        "derive_separator_contexts)")
    p.add_argument("--buckets", default="",
                   help="comma-separated length buckets in seconds (e.g. "
                        "'8')")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' "
                        "runs the plain PyTorch path)")
    return p


def main(argv=None) -> list:
    args = parser().parse_args(argv)

    from nhans_tpu_torch.cli._app import load_enhancer
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.utils import wavio
    from nhans_tpu_torch.utils.scoring import pesq_score, si_sdr, stoi

    cfg = (Config.separator() if args.task == "separator"
           else Config.denoiser())
    buckets = ([float(b) for b in args.buckets.split(",")]
               if args.buckets else None)
    enh = load_enhancer(cfg, args.checkpoint, buckets_seconds=buckets,
                        device=args.device)

    examples = find_examples(args.demo_root, args.task)
    if args.limit:
        examples = examples[:args.limit]
    if not examples:
        print("no examples found")
        return []

    records = []
    for ex in examples:
        mixed = wavio.read_for_processing(ex["mixed"])
        neg = (wavio.read_for_processing(ex["neg"]) if ex["neg"]
               else np.zeros(16000))
        pos = (wavio.read_for_processing(ex["pos"]) if ex["pos"]
               else np.zeros(16000))
        if args.task == "separator" and not ex["pos"] and not ex["neg"]:
            # source_separation example dirs ship only mixed + the
            # published model's output: carve both contexts from it
            g = wavio.read_for_processing(ex["golden"])
            pos, neg = derive_separator_contexts(mixed, g,
                                                 mode=args.ctx_mode)
        if args.task == "separator":
            ctx_a, ctx_b = neg, pos
        else:
            ctx_a, ctx_b = pos, neg
        out = enh.enhance(mixed, ctx_a, ctx_b)
        den = out["denoised"]
        den_ac = (enh.compensate(den, out["removed"], out["snr_est"],
                                 ac=True) if args.ac else None)
        golden = wavio.read_for_processing(ex["golden"])
        golden = golden / (np.max(np.abs(golden)) + 1e-6)
        rec = dict(example=ex["name"],
                   si_sdr_vs_golden=si_sdr(den, golden),
                   si_sdr_mixed_vs_golden=si_sdr(
                       out["mixed_processed"], golden))
        row = [f"{ex['name']:12s}",
               f"SI-SDR(ours, golden) = {rec['si_sdr_vs_golden']:7.2f} dB"]
        if ex["target"]:
            target = wavio.read_for_processing(ex["target"])
            target = target / (np.max(np.abs(target)) + 1e-6)
            mixed_n = out["mixed_processed"]
            rec.update(
                si_sdr_ours=si_sdr(den, target),
                si_sdr_mixed=si_sdr(mixed_n, target),
                si_sdr_golden=si_sdr(golden, target),
                stoi_ours=stoi(den, target),
                stoi_mixed=stoi(mixed_n, target),
                stoi_golden=stoi(golden, target))
            row.append(f"SI-SDR(ours, target) = {rec['si_sdr_ours']:7.2f}")
            row.append(f"SI-SDR(mixed, target) = {rec['si_sdr_mixed']:7.2f}")
            row.append(f"SI-SDR(golden, target) = {rec['si_sdr_golden']:7.2f}")
            row.append(f"STOI(ours) = {rec['stoi_ours']:5.3f}")
            row.append(f"STOI(mixed) = {rec['stoi_mixed']:5.3f}")
            p = pesq_score(den, target)
            if p is not None:
                rec["pesq_ours"] = p
                row.append(f"PESQ = {p:4.2f}")
            if den_ac is not None:
                rec["si_sdr_ours_ac"] = si_sdr(den_ac, target)
                rec["stoi_ours_ac"] = stoi(den_ac, target)
                row.append(f"SI-SDR(ours+ac, target) = "
                           f"{rec['si_sdr_ours_ac']:7.2f}")
        records.append(rec)
        print("  ".join(row))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"records -> {args.json}")
    return records


if __name__ == "__main__":
    main()
