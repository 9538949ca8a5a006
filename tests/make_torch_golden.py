"""Golden serving output of the JAX package, for holding the PyTorch port
to it where JAX is not installed (the machine with the GPU).

    python tests/make_torch_golden.py

runs ``nhans_tpu``'s ``Enhancer(out_wire="float32")`` with the shipped
``docs/quality/denoiser_q5_swa.npz`` on a seeded 1.5 s input and writes
``tests/data/torch_golden_denoiser.npz``: the seed, a digest of the
regenerated inputs, ``denoised``, ``mixed_processed``, ``snr_est`` and
``cap_clip_frac``.  ``tests/test_torch_golden.py`` checks that the JAX
package still reproduces the file and that the port does too;
``chip_smoke.py`` checks the port on the card against it.

The helpers here (``golden_inputs``, ``jax_variables``) are shared by the
port's tests.  ``golden_inputs`` needs numpy only.
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_denoiser.npz")
DENOISER_NPZ = os.path.join(REPO, "docs", "quality", "denoiser_q5_swa.npz")
SEPARATOR_NPZ = os.path.join(REPO, "docs", "quality", "separator_q5_swa.npz")
SEED = 20240

# waveforms of the golden run (normalised to a peak of about 1) and the
# SNR estimate: JAX against its own fixture on a CPU, float32 throughout
JAX_WAVE_ATOL = 1e-5
JAX_SNR_RTOL = 1e-5


def golden_inputs(seed: int = SEED):
    """(mixed, pos, neg) at int16 scale, float64: a 1.5 s harmonic tone
    with a moving pitch in noise, 0.8 s of noise as the positive context
    (shorter than a context, so it is tiled) and 2.5 s of louder noise as
    the negative context (longer than a context, so it is cut)."""
    rng = np.random.default_rng(seed)
    t = np.arange(24000) / 16000.0
    f0 = 180.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    voice = sum(np.sin(h * phase) / h for h in range(1, 8))
    envelope = 0.6 + 0.4 * np.sin(2 * np.pi * 2.3 * t)
    neg = rng.standard_normal(40000) * 2500.0
    mixed = 6000.0 * envelope * voice + neg[:24000]
    pos = rng.standard_normal(12800) * 800.0
    return mixed, pos, neg


def input_digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()


def jax_variables(npz_path: str) -> dict:
    """The flat ``.npz`` as the nested float32 flax variables that the
    JAX package's modules take."""
    tree: dict = {}
    with np.load(npz_path) as z:
        for key in z.files:
            parts = key.split("/")
            d = tree
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = np.asarray(z[key], np.float32)
    return tree


def jax_golden_run() -> dict:
    """The JAX package's output on the golden inputs (CPU)."""
    from nhans_tpu.config import Config
    from nhans_tpu.infer.enhance import Enhancer

    enh = Enhancer(Config.denoiser(), jax_variables(DENOISER_NPZ),
                   out_wire="float32")
    return enh.enhance(*golden_inputs())


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    out = jax_golden_run()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(
        GOLDEN, seed=np.int64(SEED),
        input_sha256=np.array(input_digest(*golden_inputs())),
        denoised=np.asarray(out["denoised"], np.float32),
        mixed_processed=np.asarray(out["mixed_processed"], np.float32),
        snr_est=np.float32(out["snr_est"]),
        cap_clip_frac=np.float32(out["cap_clip_frac"]))
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
