"""Build dataset manifests: ``python -m nhans_tpu_torch.cli.seeds
--speech_wav_dir DIR [--noise_wav_dir DIR]`` writes
``DIR/{train,valid,test}.json`` from the wavs under ``DIR/<split>/``."""

from __future__ import annotations

import argparse

from nhans_tpu_torch.data.manifest import create_seeds


def main() -> None:
    p = argparse.ArgumentParser(prog="python -m nhans_tpu_torch.cli.seeds")
    p.add_argument("--speech_wav_dir", default="./speech_wav_dir/")
    p.add_argument("--noise_wav_dir", default="")
    p.add_argument("--format", choices=("json", "pkl"), default="json")
    p.add_argument("--split_lists", default="",
                   help="directory of {train,valid,test}.txt utterance-ID "
                        "lists (SPL reproduction splits); resolved against "
                        "--speech_wav_dir")
    args = p.parse_args()
    if args.split_lists:
        from nhans_tpu_torch.data.manifest import create_seeds_from_split_lists
        splits = create_seeds_from_split_lists(
            args.split_lists, args.speech_wav_dir, args.speech_wav_dir,
            fmt=args.format)
        print(f"{args.speech_wav_dir}: " + ", ".join(
            f"{k}={len(v)}" for k, v in splits.items()))
        return
    for d in filter(None, [args.speech_wav_dir, args.noise_wav_dir]):
        splits = create_seeds(d, args.format)
        print(f"{d}: " + ", ".join(f"{k}={len(v)}" for k, v in splits.items()))


if __name__ == "__main__":
    main()
