"""Golden outputs of the JAX package, for holding the PyTorch port to
them where JAX is not installed (the machine with the GPU).

    python tests/make_torch_golden.py          # serving
    python tests/make_torch_golden.py train    # one training step
    python tests/make_torch_golden.py train_bf16  # the same in bfloat16
    python tests/make_torch_golden.py eval     # an evaluation pass
    python tests/make_torch_golden.py dp       # a step over 2 data ranks
    python tests/make_torch_golden.py random_init  # serving a fresh init
    python tests/make_torch_golden.py flops    # FLOP counts, JAX and port
    python tests/make_torch_golden.py orbax    # the Orbax fixtures
    python tests/make_torch_golden.py orbax_read  # time a full-width read
    python tests/make_torch_golden.py orbax_write  # the port's full-width
                                   # write, and the JAX package's read of it

The first runs ``nhans_tpu``'s ``Enhancer(out_wire="float32")`` with the
shipped ``docs/quality/denoiser_q5_swa.npz`` on a seeded 1.5 s input and
writes ``tests/data/torch_golden_denoiser.npz``: the seed, a digest of the
regenerated inputs, ``denoised``, ``mixed_processed``, ``snr_est`` and
``cap_clip_frac``.  ``tests/test_torch_golden.py`` checks that the JAX
package still reproduces the file and that the port does too;
``chip_smoke.py`` checks the port on the card against it.

The second takes one full-width sgd step of the JAX package's train step
from the same weights on one seeded utterance x 2 crops and writes
``tests/data/torch_golden_train.npz``: the inputs' digest, the step's
random draws, the loss, the gradient norm, the update of a few layers
(``delta/<flax path>``) and two BatchNorms' new statistics
(``stats/<flax path>``).  ``tests/test_torch_train_golden.py`` and
``chip_smoke.py`` hold the port to it.  ``train_bf16`` takes the same
step on the same inputs and draws with ``compute_dtype="bfloat16"`` and
writes ``tests/data/torch_golden_train_bf16.npz`` with the same keys
and three distances (``train_gap``): ``gap/<key>``, how far that step
lies from the float32 one; ``spread/<key>``, the most it moves when the
weights are perturbed by 1e-6 relative, over ``SPREAD_SEEDS`` draws; and
``strict/<key>``, how far it lies from the same step compiled to round
every bfloat16 value the program names (XLA's
``xla_allow_excess_precision`` off; by default XLA on a CPU keeps some
intermediates in float32).  The bars of the port's bfloat16 step
(``tests/test_torch_train_golden.py``, ``chip_smoke.py``) come from these.

The third runs the JAX package's ``Evaluator`` at full width with the
same weights on two seeded utterances of 2.45 and 2.5 s (one group of
two, one 2.5 s bucket), passed as example dicts with fixed SNRs, and
writes ``tests/data/torch_golden_eval.npz``: the inputs' digest, the
SNRs and lengths, the metrics (``metric/<name>``), each utterance's mean
window loss and scores (``utt/<name>``, scored from the dumped
reconstructions) and the ``denoised`` waveforms.
``tests/test_torch_eval_golden.py`` and ``chip_smoke.py`` hold the port
to it through ``port_eval_golden``.

The fourth (``dp``) takes one full-width sgd step of the JAX package's
``make_train_step(mesh=make_mesh(data=2))`` on two CPU devices from the
same weights, on two seeded utterances (``golden_dp_inputs``, one a data
rank) x 2 crops, and writes ``tests/data/torch_golden_train_dp.npz`` with
the training golden's keys.  ``chip_smoke.py`` holds the port's step on
two ranks to it (``port_train_golden`` with a mesh).

The fifth (``random_init``) serves ``random_init_inputs`` (the serving
golden's inputs as the int16 wavs a command line reads) through the JAX
package's ``Enhancer(out_wire="float32")`` with the ``PRNGKey(0)``
initialisation its CLIs use without ``--checkpoint``, for each task in
the CLI's context slots, and writes ``tests/data/torch_golden_random_init.npz``:
the inputs' digest, ``<task>/denoised``, ``<task>/removed`` and
``<task>/snr_est``, and ``mixed_processed`` once (it does not depend on
the task).  That init's ``last_dense`` is zero, so its residual is 0 and
the output depends on no random draw: the port's own seeded init must
reproduce it (``tests/test_torch_load_model.py``, ``chip_smoke.py``
phase 16).

``run_ranks`` starts a function as the ranks of a ``torch.distributed``
world, a process each, joined through a ``file://`` store in a temporary
directory; the port's multi-process tests and ``chip_smoke.py`` use it.

The helpers here (``golden_inputs``, ``jax_variables``, ``twin_configs``,
``jax_train_draws``, ``golden_eval_examples``) are shared by the port's
tests.  ``golden_inputs``, ``golden_eval_examples``, ``run_ranks`` and the
``port_*`` functions need no JAX.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_golden_denoiser.npz")
GOLDEN_TRAIN = os.path.join(REPO, "tests", "data", "torch_golden_train.npz")
GOLDEN_TRAIN_BF16 = os.path.join(REPO, "tests", "data",
                                 "torch_golden_train_bf16.npz")
GOLDEN_EVAL = os.path.join(REPO, "tests", "data", "torch_golden_eval.npz")
GOLDEN_TRAIN_DP = os.path.join(REPO, "tests", "data",
                               "torch_golden_train_dp.npz")
GOLDEN_RANDOM_INIT = os.path.join(REPO, "tests", "data",
                                  "torch_golden_random_init.npz")
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


def random_init_inputs():
    """``golden_inputs`` as the int16 samples of the wavs a command line
    reads: (mixed, pos, neg)."""
    return tuple(np.clip(np.rint(x), -32768, 32767).astype(np.int16)
                 for x in golden_inputs())


def jax_random_init_golden() -> dict:
    """The JAX package's serving output with its CLIs' ``PRNGKey(0)``
    init on ``random_init_inputs`` (CPU), for both tasks."""
    import jax

    from nhans_tpu.config import Config
    from nhans_tpu.infer.enhance import Enhancer
    from nhans_tpu.models import init_variables

    mixed, pos, neg = (x.astype(np.float64) for x in random_init_inputs())
    out = {"input_sha256": np.array(input_digest(mixed, pos, neg))}
    for task in ("denoiser", "separator"):
        cfg = getattr(Config, task)()
        _, variables = init_variables(cfg, jax.random.PRNGKey(0), train=False)
        enh = Enhancer(cfg, variables, out_wire="float32")
        # the CLIs' context slots: the separator takes (--neg, --pos)
        r = (enh.enhance(mixed, pos, neg) if task == "denoiser"
             else enh.enhance(mixed, neg, pos))
        processed = np.asarray(r["mixed_processed"], np.float32)
        if "mixed_processed" in out:
            assert np.array_equal(out["mixed_processed"], processed)
        out["mixed_processed"] = processed
        for key in ("denoised", "removed"):
            out[f"{task}/{key}"] = np.asarray(r[key], np.float32)
        out[f"{task}/snr_est"] = np.float64(r["snr_est"])
    return out


def write_tf_bundle(npz_path: str, task: str, prefix: str) -> dict:
    """The weights of a flat ``.npz`` written as a TF bundle under their
    TF names (the inverse of the port's ``tf_name_map``): float32, biases
    and BatchNorm tensors [1, 1, 1, C], and for the separator the unused
    ``Variable`` its published bundle keeps.  Returns the flat float32
    weights."""
    from nhans_tpu_torch.compat.tf_bundle import write_bundle
    from nhans_tpu_torch.compat.tf_import import flax_key, tf_name_map

    with np.load(npz_path) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    tensors = {}
    for tf_name, (coll, path) in tf_name_map(task).items():
        a = flat[flax_key(coll, path)]
        tensors[tf_name] = a.reshape(1, 1, 1, -1) if a.ndim == 1 else a
    if task == "separator":
        tensors["Variable"] = np.array(545000, np.int64)
    write_bundle(prefix, tensors)
    return flat


def write_demo_tree(root: str, clean, noise, other) -> None:
    """A corpus in the ``DEMO_N-HANS`` layout under ``root``, as int16
    wavs from int16-scale signals of one length: ``denoising/example1``
    with ``mixed`` (clean + noise), ``denoised`` (a stand-in for the
    published output: clean + noise / 10), ``target`` (clean) and
    ``negNoise`` (noise), and ``source_separation/example1`` with only
    ``mixed`` (clean + other) and ``separated`` (clean + other / 10), as
    the published separation examples ship."""
    from scipy.io import wavfile

    def write(sub, kind, x):
        d = os.path.join(root, sub, "example1")
        os.makedirs(d, exist_ok=True)
        wavfile.write(os.path.join(d, f"example1_{kind}.wav"), 16000,
                      np.clip(np.rint(x), -32768, 32767).astype(np.int16))

    for kind, x in (("mixed", clean + noise), ("denoised", clean + noise / 10),
                    ("target", clean), ("negNoise", noise)):
        write("denoising", kind, x)
    for kind, x in (("mixed", clean + other),
                    ("separated", clean + other / 10)):
        write("source_separation", kind, x)


# the training golden: one utterance of 261 frames, 2 crops, sgd
TRAIN_SEED = 20250
TRAIN_SLICES = 2
TRAIN_LR = 1e-3
# perturbed bfloat16 steps whose largest distance is the golden's spread
SPREAD_SEEDS = 4
TRAIN_LAYERS = ("embedding/block1/conv1/w", "resblock1/conv1/w",
                "resblock8/bn_out/beta", "last_dense/b")
TRAIN_STATS = ("embedding/block1/bn1", "last_bn")


def golden_train_inputs(seed: int = TRAIN_SEED) -> dict:
    """One training batch of raw int16 buffers (B = 1), as the loaders
    deliver them: a 2.6 s harmonic utterance, a positive noise shorter
    than it and a louder negative noise longer than it, with the valid
    lengths and whole-file peaks."""
    rng = np.random.default_rng(seed)
    L = 400 + 160 * 260
    t = np.arange(L) / 16000.0
    f0 = 160.0 + 30.0 * np.sin(2 * np.pi * 0.9 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    voice = sum(np.sin(h * phase) / h for h in range(1, 7))
    clean = 7000.0 * voice + rng.standard_normal(L) * 400.0
    noise_a = np.zeros(L)
    noise_a[:23000] = rng.standard_normal(23000) * 1500.0
    noise_b = rng.standard_normal(L) * 3000.0
    batch = {k: np.rint(v)[None].astype(np.int16) for k, v in
             (("clean", clean), ("noise_a", noise_a), ("noise_b", noise_b))}
    batch.update(clean_len=np.array([L], np.int32),
                 len_a=np.array([23000], np.int32),
                 len_b=np.array([L], np.int32))
    batch["peaks"] = np.stack(
        [np.abs(batch[k]).max(1) for k in ("clean", "noise_a", "noise_b")],
        axis=1).astype(np.float32)
    return batch


def golden_dp_inputs() -> dict:
    """The data-parallel golden's batch (B = 2): ``golden_train_inputs``
    of two seeds, stacked; one utterance a data rank."""
    a, b = golden_train_inputs(TRAIN_SEED), golden_train_inputs(TRAIN_SEED + 1)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


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


def twin_configs(task: str = "denoiser", **sections):
    """(JAX package Config, port Config) of ``task`` with the same fields
    replaced in each section, e.g. ``model=dict(window_frames=9)``."""
    import dataclasses

    from nhans_tpu.config import Config as JConfig
    from nhans_tpu_torch.config import Config as TConfig

    out = []
    for cls in (JConfig, TConfig):
        cfg = getattr(cls, task)()
        cfg = cfg.replace(**{name: dataclasses.replace(getattr(cfg, name),
                                                       **fields)
                             for name, fields in sections.items()})
        out.append(cfg)
    return tuple(out)


def jax_train_draws(cfg, key, batch: int, slices: int) -> dict:
    """The random draws that ``nhans_tpu.data.pipeline.make_train_batch``
    takes from ``key``, replayed with its ``jax.random`` splits, as numpy
    arrays under the names of the port's ``draw_train_batch``."""
    import jax
    import jax.numpy as jnp

    B, K = batch, slices
    (k_snr_a, k_snr_b, k_win, k_ctx_a, k_ctx_b,
     k_aug_a, k_aug_b) = jax.random.split(key, 7)
    n = len(cfg.task.snr_set) + (3 if cfg.data.snr_augment else 0)
    draws = {"snr_a": jax.random.randint(k_snr_a, (B,), 0, n),
             "snr_b": jax.random.randint(k_snr_b, (B,), 0, n),
             "u_win": jax.random.uniform(k_win, (B, K)),
             "u_ctx_a": jax.random.uniform(k_ctx_a, (B, K)),
             "u_ctx_b": jax.random.uniform(k_ctx_b, (B, K))}
    if cfg.data.augment_noise and cfg.task.two_noise_mixing:
        for s, kk in (("a", k_aug_a), ("b", k_aug_b)):
            ks, kr, kp = jax.random.split(kk, 3)
            draws[f"shift_{s}"] = jax.random.randint(ks, (B,), 0, 1 << 30)
            draws[f"rev_{s}"] = jax.random.bernoulli(kr, shape=(B,))
            draws[f"sign_{s}"] = jnp.where(
                jax.random.bernoulli(kp, shape=(B,)), 1.0, -1.0)
    return {k: np.asarray(v) for k, v in draws.items()}


def jax_golden_run() -> dict:
    """The JAX package's output on the golden inputs (CPU)."""
    from nhans_tpu.config import Config
    from nhans_tpu.infer.enhance import Enhancer

    enh = Enhancer(Config.denoiser(), jax_variables(DENOISER_NPZ),
                   out_wire="float32")
    return enh.enhance(*golden_inputs())


def jax_train_golden(dtype: str = "float32", perturb: float = 0.0,
                     perturb_seed: int = TRAIN_SEED,
                     strict: bool = False, data: int = 1) -> dict:
    """One sgd step of the JAX package at full width (CPU) from the
    shipped denoiser weights on ``golden_train_inputs``, computed in
    ``dtype``; with ``perturb``, from the weights each times
    (1 + perturb x a standard normal draw seeded by ``perturb_seed``);
    with ``strict``, compiled with ``xla_allow_excess_precision`` off;
    with ``data`` = 2, on ``golden_dp_inputs`` under
    ``make_mesh(data=2)`` (the JAX process needs two devices)."""
    import jax
    import jax.numpy as jnp

    from nhans_tpu.models import build_model
    from nhans_tpu.train.optim import make_optimizer
    from nhans_tpu.train.step import TrainState, make_train_step

    jcfg, _ = twin_configs("denoiser", model=dict(compute_dtype=dtype),
                           data=dict(slices_per_step=TRAIN_SLICES),
                           train=dict(alg="sgd", lr=TRAIN_LR))
    variables = jax_variables(DENOISER_NPZ)
    if perturb:
        rng = np.random.default_rng(perturb_seed)
        variables["params"] = jax.tree_util.tree_map(
            lambda w: (w * (1 + perturb * rng.standard_normal(w.shape))
                       ).astype(np.float32), variables["params"])
    tx = make_optimizer("sgd", TRAIN_LR)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    batch = golden_train_inputs() if data == 1 else golden_dp_inputs()
    key = jax.random.PRNGKey(TRAIN_SEED)
    if data == 1:
        step = make_train_step(jcfg, build_model(jcfg), tx, donate=False)
        args = (state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    else:
        from nhans_tpu.parallel.mesh import (make_mesh, replicated_sharding,
                                             shard_batch)
        mesh = make_mesh(data=data)
        step = make_train_step(jcfg, build_model(jcfg), tx, mesh=mesh,
                               donate=False)
        args = (jax.device_put(state, replicated_sharding(mesh)),
                shard_batch(mesh, batch), key)
    if strict:
        step = step.lower(*args).compile(
            {"xla_allow_excess_precision": False})
    new, metrics = step(*args)
    return {"seed": np.int64(TRAIN_SEED),
            **jax_step_record(jcfg, batch, key, variables["params"], new,
                              metrics)}


def jax_step_record(jcfg, batch, key, before, new, metrics) -> dict:
    """A training golden's keys of the JAX package's step from the params
    ``before`` to the state ``new`` on ``batch`` with ``key``: the
    inputs' digest, the loss, the gradient norm, the step's random
    draws, the updates of ``TRAIN_LAYERS`` and the statistics of
    ``TRAIN_STATS``."""
    def at(tree, path):
        for p in path.split("/"):
            tree = tree[p]
        return np.asarray(tree, np.float32)

    out = {"input_sha256": np.array(input_digest(*batch.values())),
           "loss": np.float32(metrics["loss"]),
           "grad_norm": np.float32(metrics["grad_norm"])}
    n = len(batch["clean"])
    for k, v in jax_train_draws(jcfg, key, n,
                                jcfg.data.slices_per_step).items():
        out[f"draws/{k}"] = v
    for path in TRAIN_LAYERS:
        out[f"delta/{path}"] = at(new.params, path) - at(before, path)
    for path in TRAIN_STATS:
        for name in ("pop_mean", "pop_variance"):
            out[f"stats/{path}/{name}"] = at(new.batch_stats,
                                             f"{path}/{name}")
    return out


def train_gap(ref: dict, other: dict, prefix: str) -> dict:
    """How far the step ``other`` lies from the step ``ref``:
    ``<prefix>/loss`` and ``<prefix>/grad_norm`` relative,
    ``<prefix>/delta/<path>`` the max |difference| of the updates over
    ``ref``'s largest |delta|, ``<prefix>/stats/<path>/<name>`` the max
    |difference| of the BatchNorm statistics."""
    out = {f"{prefix}/{k}": np.float64(abs(float(other[k]) - float(ref[k]))
                                       / abs(float(ref[k])))
           for k in ("loss", "grad_norm")}
    for path in TRAIN_LAYERS:
        want = np.asarray(ref[f"delta/{path}"], np.float64)
        out[f"{prefix}/delta/{path}"] = np.float64(
            np.abs(np.asarray(other[f"delta/{path}"]) - want).max()
            / np.abs(want).max())
    for path in TRAIN_STATS:
        for name in ("pop_mean", "pop_variance"):
            key = f"stats/{path}/{name}"
            out[f"{prefix}/{key}"] = np.float64(
                np.abs(np.asarray(other[key], np.float64) - ref[key]).max())
    return out


def port_train_golden(device="cpu", golden=None, dtype="float32",
                      mesh=None) -> dict:
    """The port's train step on the training golden's inputs and draws,
    from the same weights, on ``device``, computed in ``dtype``: the
    file's keys, computed by the port.  With a ``mesh`` (a data-parallel
    golden and a process group), this rank's rows through the mesh step.
    Needs torch only."""
    import torch

    from nhans_tpu_torch.compat.weights import load_npz, to_flax
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.models import build_model
    from nhans_tpu_torch.parallel.mesh import shard_batch
    from nhans_tpu_torch.parallel.sharding_rules import shard_model
    from nhans_tpu_torch.train.step import (make_train_step, make_tx,
                                            state_of)

    if golden is None:
        with np.load(GOLDEN_TRAIN) as z:
            golden = {k: z[k] for k in z.files}
    cfg = Config.denoiser()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        data=dataclasses.replace(cfg.data, slices_per_step=TRAIN_SLICES),
        train=dataclasses.replace(cfg.train, alg="sgd", lr=TRAIN_LR))
    model = build_model(cfg)
    model.load_state_dict(load_npz(DENOISER_NPZ))
    model.to(device)
    before = to_flax(dict(model.named_parameters()), "params")
    if mesh is not None:
        shard_model(model, mesh)
    tx = make_tx(cfg)
    state = state_of(model, tx)
    draws = {k[len("draws/"):]: torch.from_numpy(np.array(v))
             for k, v in golden.items() if k.startswith("draws/")}
    inputs = (golden_train_inputs() if len(draws["snr_a"]) == 1
              else golden_dp_inputs())
    if mesh is not None:
        inputs = shard_batch(mesh, inputs)
    batch = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    metrics = make_train_step(cfg, model, tx, mesh=mesh)(state, batch, None,
                                                         draws=draws)
    return port_step_record(model, before, metrics)


def port_step_record(model, before, metrics) -> dict:
    """A training golden's computed keys of the port's step that took
    ``model`` from the flat params ``before`` (``to_flax``) and returned
    ``metrics``."""
    from nhans_tpu_torch.compat.weights import to_flax
    from nhans_tpu_torch.parallel.sharding_rules import (gather_full,
                                                         model_shards)

    after = to_flax(gather_full(dict(model.named_parameters()),
                                model_shards(model)), "params")
    stats = to_flax(dict(model.named_buffers()), "stats")
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"])}
    for path in TRAIN_LAYERS:
        out[f"delta/{path}"] = after[f"params/{path}"] - before[
            f"params/{path}"]
    for path in TRAIN_STATS:
        for name in ("pop_mean", "pop_variance"):
            out[f"stats/{path}/{name}"] = stats[f"stats/{path}/{name}"]
    return out


# The Orbax fixtures (tests/data/orbax/): a narrow model with the full-width
# model's eight main and four context blocks, so its 571 variable names, 2 to
# 4 channels wide.  A block with a stride changes its channel count, as every
# one does at full width, or it would lose its shortcut convolution.
ORBAX_DIR = os.path.join(REPO, "tests", "data", "orbax")
ORBAX_SEED = 20270
ORBAX_MODEL = dict(
    embedding_dim=1, pos_embed_hidden=2,
    main_blocks=((4, 1, 2), (4, 1, 2), (4, 2, 3), (4, 1, 3),
                 (3, 2, 2), (3, 1, 2), (3, 2, 3), (3, 1, 3)),
    context_blocks=(((8, 4), (3, 2), 2), ((8, 4), (3, 2), 3),
                    ((4, 4), (1, 1), 4), ((4, 4), (1, 2), 1)))
# the fixtures' training flags, as both packages' command lines take them
ORBAX_FLAGS = ("--lr", "1e-3", "--lr_schedule", "cosine", "--lr_decay_steps",
               "100", "--mom", "0.9", "--slices_per_step", str(TRAIN_SLICES))


def orbax_paths(root: str = ORBAX_DIR) -> dict:
    """The fixtures under ``root``: ``variables`` (a ``save_variables``
    directory) and ``npz`` (its twin), ``run`` (a ``Checkpointer`` root,
    step 1 of an Adam run) and ``golden`` (JAX's next step from it)."""
    return {"variables": os.path.join(root, "variables"),
            "npz": os.path.join(root, "variables.npz"),
            "run": os.path.join(root, "run"),
            "golden": os.path.join(root, "next_step.npz")}


def narrow(cfg):
    """``cfg`` with the Orbax fixtures' model widths."""
    return cfg.replace(model=dataclasses.replace(cfg.model, **ORBAX_MODEL))


def jax_orbax_config(alg: str, flags=ORBAX_FLAGS):
    """The JAX package's Config of the fixtures' run with ``--alg alg``
    (and ``flags``, by default the fixtures'): its command line's
    reference flags, narrowed."""
    import argparse

    from nhans_tpu.config import add_reference_flags, config_from_args

    p = argparse.ArgumentParser()
    add_reference_flags(p, inference=False)
    return narrow(config_from_args(p.parse_args(["--alg", alg, *flags])))


def jax_next_step(jcfg, model, tx, state, seed: int) -> dict:
    """The golden of the JAX package's train step from ``state`` on
    ``golden_train_inputs(seed)`` with ``PRNGKey(seed)``: the seed, the
    step it starts from and ``jax_step_record``'s keys."""
    import jax
    import jax.numpy as jnp

    from nhans_tpu.train.step import make_train_step

    step = make_train_step(jcfg, model, tx, donate=False)
    raw = golden_train_inputs(seed)
    key = jax.random.PRNGKey(seed)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in raw.items()},
                        key)
    return {"seed": np.int64(seed), "step": np.int64(state.step),
            **jax_step_record(jcfg, raw, key, state.params, new, metrics)}


def jax_orbax_state(jcfg, variables=None, grads_seed=None):
    """(model, TrainState at step 0, tx, nested variables) of the JAX
    package for ``jcfg``, as its ``create_state`` makes them, from
    ``variables`` or else from its init with every leaf moved by a seeded
    draw (so that no leaf is all zeros or ones).  With ``grads_seed``, the
    state after one optimizer update with seeded gradients instead."""
    import jax
    import jax.numpy as jnp
    import optax

    from nhans_tpu.models import build_model, init_variables
    from nhans_tpu.train.optim import make_optimizer, make_schedule
    from nhans_tpu.train.step import TrainState

    t = jcfg.train
    tx = make_optimizer(t.alg, make_schedule(t.lr, t.lr_schedule,
                                             t.lr_decay_steps,
                                             t.lr_min_frac), t.mom)
    if variables is None:
        _, init = init_variables(jcfg, jax.random.PRNGKey(ORBAX_SEED),
                                 train=True)
        rng = np.random.default_rng(ORBAX_SEED)

        def moved(path, x):
            x = np.asarray(x, np.float32)
            if jax.tree_util.keystr(path).endswith("['pop_variance']"):
                return x * rng.uniform(0.9, 1.1, x.shape).astype(np.float32)
            return x + (0.01 * rng.standard_normal(x.shape)).astype(
                np.float32)

        variables = jax.tree_util.tree_map_with_path(
            moved, {"params": init["params"],
                    "batch_stats": init["batch_stats"]})
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    if grads_seed is not None:
        g = np.random.default_rng(grads_seed)
        grads = jax.tree_util.tree_map(
            lambda x: (1e-2 * g.standard_normal(x.shape)).astype(np.float32),
            state.params)
        updates, opt = tx.update(grads, state.opt_state, state.params)
        state = state.replace(step=jnp.ones((), jnp.int32),
                              params=optax.apply_updates(state.params,
                                                         updates),
                              opt_state=opt)
    return build_model(jcfg), state, tx, variables


def jax_orbax_fixtures(root: str, alg: str = "adam",
                       variables=None) -> dict:
    """Write the Orbax fixtures under ``root`` with the JAX package's own
    ``save_variables`` and ``Checkpointer`` (CPU): the variables of
    ``jax_orbax_state`` (of ``variables`` if given) and their ``.npz``
    twin, and the run root of one ``--alg`` step from them on
    ``golden_train_inputs(ORBAX_SEED)``; returns (and writes) the golden
    of the next step, on ``golden_train_inputs(ORBAX_SEED + 1)``."""
    import jax
    import jax.numpy as jnp

    from nhans_tpu.train.checkpoint import Checkpointer, save_variables
    from nhans_tpu.train.step import make_train_step

    paths = orbax_paths(root)
    jcfg = jax_orbax_config(alg)
    model, state, tx, variables = jax_orbax_state(jcfg, variables)
    # host arrays, as tools/ckpt_npz.py unpack and ckpt_average save them
    save_variables(paths["variables"], variables)
    np.savez_compressed(paths["npz"], **{
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
        for path, x in jax.tree_util.tree_flatten_with_path(variables)[0]})
    step = make_train_step(jcfg, model, tx, donate=False)
    batch = {k: jnp.asarray(v)
             for k, v in golden_train_inputs(ORBAX_SEED).items()}
    state, _ = step(state, batch, jax.random.PRNGKey(ORBAX_SEED))
    # as the trainer saves: a host snapshot at its step
    ckpt = Checkpointer(paths["run"])
    ckpt.save(int(state.step), jax.device_get(state))
    ckpt.wait()
    ckpt.close()
    golden = jax_next_step(jcfg, model, tx, state, ORBAX_SEED + 1)
    np.savez_compressed(paths["golden"], **golden)
    return golden


def orbax_read_times(repeats: int = 5) -> dict:
    """The shipped denoiser weights written at full width by the JAX
    package's ``save_variables`` (host arrays, a temporary directory) and
    read by the port's ``load_variables``: the directory's bytes and each
    read's wall seconds on this machine's CPU (the first is the first in
    the process; the page cache is warm from the write)."""
    from nhans_tpu.train.checkpoint import save_variables
    from nhans_tpu_torch.train.checkpoint import load_variables

    with tempfile.TemporaryDirectory() as tmp:
        save_variables(os.path.join(tmp, "q5"), jax_variables(DENOISER_NPZ))
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp) for f in fs)
        seconds = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            n = len(load_variables(os.path.join(tmp, "q5")))
            seconds.append(time.perf_counter() - t0)
    return {"arrays": n, "bytes": size, "read_s": seconds}


def orbax_write_times(repeats: int = 3) -> dict:
    """The shipped denoiser weights written at full width by the port's
    ``save_variables`` (a temporary directory) and read back by the JAX
    package's ``load_variables``: the directory's bytes and each write's
    and read's wall seconds on the CPU it runs on (the page cache warm
    from the write)."""
    import jax

    from nhans_tpu.train.checkpoint import load_variables as jax_load
    from nhans_tpu_torch.train.checkpoint import save_variables

    with np.load(DENOISER_NPZ) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    out = {"arrays": len(flat), "write_s": [], "read_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "q5")
        for _ in range(repeats):
            t0 = time.perf_counter()
            save_variables(path, flat)
            out["write_s"].append(time.perf_counter() - t0)
        out["bytes"] = sum(os.path.getsize(os.path.join(d, f))
                           for d, _, fs in os.walk(tmp) for f in fs)
        for _ in range(repeats):
            t0 = time.perf_counter()
            n = len(jax.tree_util.tree_leaves(jax_load(path)))
            out["read_s"].append(time.perf_counter() - t0)
        assert n == len(flat)
    return out


def port_orbax_trainer(run: str, alg: str, device, workdir: str):
    """The port's Trainer of ``python -m nhans_tpu_torch.cli.train
    --restore_path run --alg alg`` with the fixtures' flags, its model
    narrowed (the command line has no width flags), writing under
    ``workdir`` (and, where ``run`` is empty, resuming from there)."""
    from nhans_tpu_torch.cli.train import parser
    from nhans_tpu_torch.config import config_from_args
    from nhans_tpu_torch.train.trainer import Trainer

    args = parser().parse_args([
        "--alg", alg, *ORBAX_FLAGS, "--restore_path", run,
        "--device_corpus", "off", "--eval_utts", "0",
        "--checkpoint_dir", os.path.join(workdir, "ck"),
        "--summaries_dir", os.path.join(workdir, "sum")])
    return Trainer(narrow(config_from_args(args)), eval_utts=0,
                   device=device)


def port_orbax_step(trainer, golden) -> dict:
    """The port's next step from ``trainer`` (``port_orbax_trainer``) on
    the golden's inputs and draws: the golden's computed keys."""
    import torch

    from nhans_tpu_torch.compat.weights import to_flax

    before = to_flax(dict(trainer.model.named_parameters()), "params")
    draws = {k[len("draws/"):]: torch.from_numpy(np.array(v))
             for k, v in golden.items() if k.startswith("draws/")}
    batch = {k: torch.from_numpy(v).to(trainer.device) for k, v in
             golden_train_inputs(int(golden["seed"])).items()}
    metrics = trainer.step_fn(trainer.state, batch, None, draws=draws)
    return port_step_record(trainer.model, before, metrics)


# the evaluation golden: one group of two utterances on a 2.5 s bucket
EVAL_SEED = 20260
EVAL_KW = dict(eval_batch=2, buckets_seconds=(2.5,), window_chunk=256)
EVAL_SCORES = ("si_sdr", "stoi", "estoi", "pesq")


def golden_eval_examples(seed: int = EVAL_SEED) -> list:
    """Two evaluation examples as ``EvalLoader`` yields them (int16-scale
    float32 samples, lengths, whole-file peaks, fixed SNRs and made-up
    paths): harmonic utterances of 2.45 and 2.5 s with a moving pitch, a
    positive noise shorter than the utterance and a louder negative noise
    longer than it."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (n, snr_a, snr_b) in enumerate(((39200, 0, 5), (40000, -5, 0))):
        t = np.arange(n) / 16000.0
        f0 = 150.0 + 40.0 * i + 30.0 * np.sin(2 * np.pi * 0.8 * t)
        phase = 2 * np.pi * np.cumsum(f0) / 16000.0
        voice = sum(np.sin(h * phase) / h for h in range(1, 7))
        clean = 7000.0 * voice * (0.6 + 0.4 * np.sin(2 * np.pi * 2.1 * t))
        na = rng.standard_normal(21000 + 3000 * i) * 1200.0
        nb = rng.standard_normal(45000) * 2500.0
        ex = {k: np.rint(v).astype(np.float32)
              for k, v in (("clean", clean), ("noise_a", na),
                           ("noise_b", nb))}
        ex.update(clean_len=n, len_a=len(na), len_b=len(nb),
                  snr_a=snr_a, snr_b=snr_b,
                  cleanpath=f"golden/clean{i}.wav",
                  path_a=f"golden/pos{i}.wav", path_b=f"golden/neg{i}.wav")
        ex["peaks"] = np.asarray([np.abs(ex[k]).max() for k in
                                  ("clean", "noise_a", "noise_b")],
                                 np.float32)
        out.append(ex)
    return out


def eval_digest(examples) -> str:
    return input_digest(*[ex[k] for ex in examples
                          for k in ("clean", "noise_a", "noise_b")])


def _eval_record(metrics: dict, dump: str, scoring) -> dict:
    """The golden file's keys from an evaluator's metrics and its dumped
    per-window losses and reconstructions, scored with ``scoring``."""
    out = {f"metric/{k}": np.float64(v) for k, v in metrics.items()}
    n = len(glob.glob(os.path.join(dump, "golden_eval_0_loss_*.npy")))
    utt = {k: [] for k in ("loss",) + EVAL_SCORES}
    for i in range(n):
        def load(kind):
            return np.load(os.path.join(dump,
                                        f"golden_eval_0_{kind}_{i}.npy"))
        den, tgt = load("denoised"), load("target")
        utt["loss"].append(float(np.mean(load("loss"))))
        utt["si_sdr"].append(scoring.si_sdr(den, tgt))
        utt["stoi"].append(scoring.stoi(den, tgt, 16000))
        utt["estoi"].append(scoring.estoi(den, tgt, 16000))
        utt["pesq"].append(scoring.pesq_score(den, tgt, 16000))
        out[f"denoised_{i}"] = den.astype(np.float32)
    out.update({f"utt/{k}": np.asarray(v, np.float64)
                for k, v in utt.items()})
    return out


def jax_eval_golden() -> dict:
    """The JAX package's Evaluator at full width (CPU) with the shipped
    denoiser on ``golden_eval_examples``."""
    from nhans_tpu.config import Config
    from nhans_tpu.models import build_model
    from nhans_tpu.train.evaluate import Evaluator
    from nhans_tpu.utils import scoring

    cfg = Config.denoiser()
    examples = golden_eval_examples()
    with tempfile.TemporaryDirectory() as dump:
        metrics = Evaluator(cfg, build_model(cfg), **EVAL_KW).run(
            jax_variables(DENOISER_NPZ), examples, modelname="golden",
            dump_results=dump, return_metrics=True)
        out = _eval_record(metrics, dump, scoring)
    out.update(seed=np.int64(EVAL_SEED),
               input_sha256=np.array(eval_digest(examples)),
               snr_a=np.asarray([ex["snr_a"] for ex in examples]),
               snr_b=np.asarray([ex["snr_b"] for ex in examples]),
               clean_len=np.asarray([ex["clean_len"] for ex in examples]))
    return out


def port_eval_golden(device="cpu") -> dict:
    """The port's Evaluator on the evaluation golden's examples with the
    same weights, on ``device``: the file's metric, per-utterance and
    waveform keys, computed by the port.  Needs torch only."""
    from nhans_tpu_torch.compat.weights import load_npz
    from nhans_tpu_torch.config import Config
    from nhans_tpu_torch.models import build_model
    from nhans_tpu_torch.train.evaluate import Evaluator
    from nhans_tpu_torch.utils import scoring

    cfg = Config.denoiser()
    model = build_model(cfg)
    model.load_state_dict(load_npz(DENOISER_NPZ))
    evaluator = Evaluator(cfg, model.to(device), **EVAL_KW)
    with tempfile.TemporaryDirectory() as dump:
        metrics = evaluator.run(None, golden_eval_examples(),
                                modelname="golden", dump_results=dump,
                                return_metrics=True)
        return _eval_record(metrics, dump, scoring)


def run_ranks(world: int, target: str, *args, backend: str = "auto",
              timeout: float = 120.0, env=None) -> list:
    """Run ``target`` ("module:function", importable from the repository's
    root) as the ``world`` ranks of a ``torch.distributed`` world, one
    process each: ``function(rank, world, *args)`` after the process has
    joined the world through a ``file://`` store in a temporary directory
    (``backend`` "auto" lets ``initialize_multihost`` choose).  Each rank
    gets ``LOCAL_RANK`` = its rank and ``LOCAL_WORLD_SIZE`` = ``world``.
    Waits for every rank; a rank that fails, or a run past ``timeout``
    seconds, stops the others and raises with the outputs.  Returns each
    rank's output (stdout and stderr)."""
    with tempfile.TemporaryDirectory(prefix="nhans_ranks_") as tmp:
        store = f"file://{tmp}/store"
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from tests.make_torch_golden import _rank_main; _rank_main()")
        procs, logs = [], []
        for r in range(world):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            penv = dict(os.environ, **(env or {}), LOCAL_RANK=str(r),
                        LOCAL_WORLD_SIZE=str(world))
            penv["PYTHONPATH"] = REPO + os.pathsep + penv.get("PYTHONPATH",
                                                              "")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, REPO, target, str(world), str(r),
                 store, backend, *map(str, args)], cwd=REPO, env=penv,
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout} s"
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    if failed:
        raise RuntimeError(f"{target} on {world} ranks: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs)))
    return outs


def _rank_main() -> None:
    """The body of a ``run_ranks`` process: argv is the repository, the
    target, the world size, the rank, the store, the backend and the
    target's arguments."""
    import importlib

    import torch.distributed as dist

    from nhans_tpu_torch.parallel.mesh import initialize_multihost

    _, target, world, r, store, backend, *args = sys.argv[1:]
    initialize_multihost(store, int(world), int(r),
                         None if backend == "auto" else backend)
    module, name = target.split(":")
    try:
        getattr(importlib.import_module(module), name)(int(r), int(world),
                                                       *args)
    finally:
        dist.destroy_process_group()


# biases whose exact gradient is zero (a BatchNorm takes the shift out):
# their updates are rounding noise, compared by nothing
NOISE_BIASES = ("conv2.b", "transform.b", "proj_a.b", "proj_b.b")


def _spec(path: str) -> dict:
    """A rank's instructions, pickled by the test or script that started
    it (``run_ranks``)."""
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def rank_steps(rank: int, world: int, spec_path: str) -> None:
    """One rank of a mesh train step, for ``run_ranks``.  The spec holds
    ``cfg`` (a port Config), the mesh's ``data`` and ``model`` sizes,
    ``min_channels`` of the model axis's rule, flat flax ``variables``,
    the global batch (``batch``, or ``banks`` and the index triples
    ``idx``) and its global ``draws``, ``steps`` and ``out``.  Every rank
    writes ``<out>.<rank>.npz``: each step's loss and gradient norm, the
    full parameters and statistics after the steps (flat flax keys, as
    ``compat.weights.to_flax`` writes them) and the shape of each block it
    holds (``block/<state_dict name>``)."""
    import torch

    from nhans_tpu_torch.compat.weights import to_flax
    from nhans_tpu_torch.models import build_model
    from nhans_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from nhans_tpu_torch.parallel.sharding_rules import (gather_full,
                                                         model_shards,
                                                         shard_model)
    from nhans_tpu_torch.train.checkpoint import load_into
    from nhans_tpu_torch.train.step import (make_train_step, make_tx,
                                            state_of)

    torch.set_num_threads(1)
    spec = _spec(spec_path)
    cfg = spec["cfg"]
    mesh = make_mesh(spec["data"], spec["model"])
    model = build_model(cfg)
    load_into(model, spec["variables"])
    shard_model(model, mesh, spec["min_channels"])
    tx = make_tx(cfg)
    state = state_of(model, tx)
    banked = "banks" in spec
    step = make_train_step(cfg, model, tx, banked=banked, mesh=mesh)

    def tensors(d):
        return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}

    draws = tensors(spec["draws"])
    out = {"loss": [], "grad_norm": []}
    for _ in range(spec["steps"]):
        if banked:
            m = step(state, tensors(spec["banks"]),
                     tensors(shard_batch(mesh, spec["idx"])), None,
                     draws=draws)
        else:
            m = step(state, tensors(shard_batch(mesh, spec["batch"])), None,
                     draws=draws)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    shards = model_shards(model)
    out.update(to_flax(gather_full(dict(model.named_parameters()), shards),
                       "params"))
    out.update(to_flax(dict(model.named_buffers()), "batch_stats"))
    out.update({f"block/{k}": np.array(state.params[k].shape)
                for k in shards})
    np.savez(f"{spec['out']}.{rank}.npz", **out)


def rank_trainer(rank: int, world: int, spec_path: str) -> None:
    """One rank of a ``Trainer`` on the CPU, for ``run_ranks``: trains
    ``cfg`` (from the spec) to its ``batches`` steps, then builds a second
    Trainer on the same directories, which auto-resumes.  Writes
    ``<out>.<rank>.npz``: the steps reached and resumed at, whether the
    run was banked, its local utterance count and the resumed
    parameters."""
    import torch

    from nhans_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    spec = _spec(spec_path)
    kw = dict(eval_utts=spec["eval_utts"], device="cpu",
              eval_kwargs=spec["eval_kwargs"])
    tr = Trainer(spec["cfg"], **kw)
    tr.train()
    again = Trainer(spec["cfg"], **kw)
    np.savez(f"{spec['out']}.{rank}.npz", tstep=tr.tstep,
             resumed=again.tstep, banked=tr.banked,
             local_utts=tr.local_utts, batch_utts=tr.batch_utts,
             evaluator=tr.evaluator is not None,
             **{f"params/{k}": v.detach().numpy()
                for k, v in again.model.state_dict().items()})


def flop_counts() -> dict:
    """The FLOPs of one narrow denoiser sgd step on ``golden_train_inputs``
    (the reduced model of the port's step tests, 2 crops), on the CPU:
    ``jax``, XLA's ``cost_analysis()["flops"]`` of the JAX package's jitted
    step, as ``bench.py`` reads it; ``port``, torch's ``FlopCounterMode``
    count of the port's step, which on the CPU includes the plain
    spectrogram's DFT products; ``port_card``, that count less the four
    spectrograms', which is what the counter sees on the card, where the
    spectrogram is a kernel it does not count."""
    import jax
    import jax.numpy as jnp
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from nhans_tpu.train.step import create_state as j_create_state
    from nhans_tpu.train.step import make_train_step as j_make_train_step
    from nhans_tpu_torch.ops.stft_cuda import log_spectrogram_plain
    from nhans_tpu_torch.train.step import create_state, make_train_step

    model = dict(window_frames=9, context_frames=20, embedding_dim=16,
                 pos_embed_hidden=8, main_blocks=((3, 1, 8), (3, 2, 16)),
                 context_blocks=(((4, 4), (2, 2), 8), ((3, 3), (1, 2), 16)))
    jcfg, tcfg = twin_configs("denoiser", model=model,
                              data=dict(slices_per_step=TRAIN_SLICES))
    batch = golden_train_inputs()
    jmodel, jstate, jtx = j_create_state(jcfg, jax.random.PRNGKey(0))
    jstep = j_make_train_step(jcfg, jmodel, jtx, donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    compiled = jax.jit(lambda s, b, k: jstep(s, b, k)).lower(
        jstate, jbatch, jax.random.PRNGKey(1)).compile()
    jflops = float(compiled.cost_analysis()["flops"])

    def count_flops(fn):
        with FlopCounterMode(display=False) as counter:
            fn()
        return counter.get_total_flops()

    tmodel, tstate, ttx = create_state(tcfg, torch.Generator().manual_seed(0),
                                       "cpu")
    tstep = make_train_step(tcfg, tmodel, ttx)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    port = count_flops(lambda: tstep(tstate, tbatch,
                                     torch.Generator().manual_seed(1)))
    rows = torch.zeros_like(tbatch["clean"], dtype=torch.float32)
    dft = count_flops(lambda: log_spectrogram_plain(rows))
    return {"jax": jflops, "port": port, "port_card": port - 4 * dft,
            "ratio_port_to_jax": port / jflops,
            "ratio_card_to_jax": (port - 4 * dft) / jflops}


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["dp"]:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   "--xla_force_host_platform_device_count=2")
        np.savez_compressed(GOLDEN_TRAIN_DP, **jax_train_golden(data=2))
        print(f"wrote {GOLDEN_TRAIN_DP} "
              f"({os.path.getsize(GOLDEN_TRAIN_DP)} bytes)")
        return
    if sys.argv[1:] == ["train"]:
        np.savez_compressed(GOLDEN_TRAIN, **jax_train_golden())
        print(f"wrote {GOLDEN_TRAIN} ({os.path.getsize(GOLDEN_TRAIN)} bytes)")
        return
    if sys.argv[1:] == ["train_bf16"]:
        out = jax_train_golden("bfloat16")
        out.update(train_gap(jax_train_golden(), out, "gap"))
        spreads = [train_gap(out, jax_train_golden("bfloat16", 1e-6,
                                                   TRAIN_SEED + i), "spread")
                   for i in range(SPREAD_SEEDS)]
        out.update({k: np.float64(max(d[k] for d in spreads))
                    for k in spreads[0]})
        out.update(train_gap(out, jax_train_golden("bfloat16", strict=True),
                             "strict"))
        np.savez_compressed(GOLDEN_TRAIN_BF16, **out)
        print(f"wrote {GOLDEN_TRAIN_BF16} "
              f"({os.path.getsize(GOLDEN_TRAIN_BF16)} bytes)")
        return
    if sys.argv[1:] == ["flops"]:
        print(json.dumps(flop_counts()))
        return
    if sys.argv[1:] == ["random_init"]:
        np.savez_compressed(GOLDEN_RANDOM_INIT, **jax_random_init_golden())
        print(f"wrote {GOLDEN_RANDOM_INIT} "
              f"({os.path.getsize(GOLDEN_RANDOM_INIT)} bytes)")
        return
    if sys.argv[1:] == ["orbax"]:
        shutil.rmtree(ORBAX_DIR, ignore_errors=True)
        os.makedirs(ORBAX_DIR)
        jax_orbax_fixtures(ORBAX_DIR)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(ORBAX_DIR) for f in fs)
        print(f"wrote {ORBAX_DIR} ({size} bytes)")
        return
    if sys.argv[1:] == ["orbax_read"]:
        print(json.dumps(orbax_read_times()))
        return
    if sys.argv[1:] == ["orbax_write"]:
        print(json.dumps(orbax_write_times()))
        return
    if sys.argv[1:] == ["eval"]:
        np.savez_compressed(GOLDEN_EVAL, **jax_eval_golden())
        print(f"wrote {GOLDEN_EVAL} ({os.path.getsize(GOLDEN_EVAL)} bytes)")
        return
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
