"""Pack/unpack inference variables (params + batch_stats) between a
checkpoint of the port and a single float16-compressed ``.npz``, the
format the shipped ``docs/quality/*_q5_swa.npz`` come in: float16
``params/...`` and float32 ``batch_stats/...`` (their dynamic range
matters).  The port of ``tools/ckpt_npz.py``.

    python -m nhans_tpu_torch.tools.ckpt_npz pack   <checkpoint> <out.npz>
    python -m nhans_tpu_torch.tools.ckpt_npz unpack <in.npz> <variables dir>

``pack`` takes any checkpoint ``train/checkpoint.py::load`` reads (a step
directory or its run root, a variables directory, a flat ``.npz``, the
port's or the JAX package's Orbax forms); ``unpack`` writes the Orbax
variables directory both packages read (``save_variables``).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from nhans_tpu_torch.train.checkpoint import load_variables, save_variables


def pack(src: str, dst: str) -> dict:
    """Write ``src``'s variables to ``dst``; returns what was written."""
    variables = load_variables(src)
    comp = {k: (v.astype(np.float16)
                if v.dtype == np.float32 and not k.startswith("batch_stats/")
                else v) for k, v in variables.items()}
    np.savez_compressed(dst, **comp)
    mb = os.path.getsize(dst) / 1e6
    print(f"packed {len(comp)} tensors -> {dst} ({mb:.1f} MB)")
    return comp


def unpack(src: str, dst: str) -> str:
    """Write the float32 variables of the ``.npz`` ``src`` as the
    variables directory ``dst``."""
    with np.load(src) as z:
        flat = {k: (z[k].astype(np.float32) if z[k].dtype == np.float16
                    else z[k]) for k in z.files}
    save_variables(dst, flat)
    print(f"unpacked {len(flat)} tensors -> {dst}")
    return dst


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3 or argv[0] not in ("pack", "unpack"):
        print(__doc__)
        sys.exit(2)
    (pack if argv[0] == "pack" else unpack)(argv[1], argv[2])


if __name__ == "__main__":
    main()
