"""The port's serving command lines (python -m nhans_tpu_torch.cli.<task>
--device cpu) against the JAX package's Enhancer(out_wire="float32")
followed by nhans_tpu.utils.wavio.write_wav on the same seeded wavs and
the same shipped weights.  Output wavs within 1e-4 (absolute, float32
wavs of peak about 1; 1e-4 of the peak where a rigged head makes the
output far louder) and the printed snr_est within 1e-4 relative, the bars
of tests/test_torch_enhance.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

import dataclasses

from nhans_tpu.cli._app import demo_mix as j_demo_mix
from nhans_tpu.config import Config as JConfig
from nhans_tpu.infer.enhance import Enhancer as JEnhancer
from nhans_tpu.utils import wavio as jwavio
from tests.make_torch_golden import DENOISER_NPZ, SEPARATOR_NPZ, jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE_ATOL = 1e-4
SNR_RTOL = 1e-4


def _cli(task, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", f"nhans_tpu_torch.cli.{task}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **(env or {})))


def _write(path, samples):
    wavfile.write(str(path), 16000, np.rint(samples).astype(np.int16))


def _seeded_wavs(tmp_path, seed, seconds):
    """Utterances under tmp_path/in, contexts pos.wav and neg.wav beside."""
    rng = np.random.default_rng(seed)
    (tmp_path / "in").mkdir()
    paths = []
    for i, s in enumerate(seconds):
        t = np.arange(int(s * 16000)) / 16000.0
        x = 5000 * np.sin(2 * np.pi * (200 + 50 * i) * t) \
            + rng.standard_normal(len(t)) * 1500
        paths.append(tmp_path / "in" / f"utt{i}.wav")
        _write(paths[-1], x)
    for name, n, scale in (("pos.wav", 6000, 600), ("neg.wav", 40000, 1500)):
        _write(tmp_path / name, rng.standard_normal(n) * scale)
    return paths


def _read(path):
    rate, x = wavfile.read(str(path))
    assert rate == 16000 and x.dtype == np.float32
    return x


@pytest.mark.parametrize("task", ["denoiser", "separator"])
def test_help_has_reference_flags(task):
    r = _cli(task, "--help")
    assert r.returncode == 0, r.stderr
    for flag in ("--input", "--output", "--pos", "--neg", "--compensate",
                 "--ac", "--Fs", "--checkpoint", "--demo", "--device",
                 "--recon_residual_cap", "--mesh"):
        assert flag in r.stdout, flag


@pytest.mark.parametrize("args,env,needle", [
    ([], {"NHANS_FREQ_PAD": "abc"}, "NHANS_FREQ_PAD"),
    (["--checkpoint", "no/such/checkpoint"], {}, "no checkpoint at"),
])
def test_refusals_are_messages_not_tracebacks(args, env, needle):
    r = _cli("denoiser", "--device", "cpu", *args, env=env)
    assert r.returncode != 0
    assert needle in r.stderr
    assert "Traceback" not in r.stderr


def test_default_device_needs_a_card(tmp_path):
    """With no card the default --device cuda refuses to run on the CPU."""
    r = _cli("denoiser", "--checkpoint", DENOISER_NPZ,
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert "Traceback" not in r.stderr


def test_denoiser_folder_mode_matches_jax(tmp_path):
    _seeded_wavs(tmp_path, 11, [0.7, 0.45])
    out_dir = tmp_path / "out"
    r = _cli("denoiser", "--device", "cpu", "--checkpoint", DENOISER_NPZ,
             "--input", str(tmp_path / "in"),
             "--pos", str(tmp_path / "pos.wav"),
             "--neg", str(tmp_path / "neg.wav"), "--output", str(out_dir),
             "--compensate", "0.25")
    assert r.returncode == 0, r.stderr
    snrs = [float(line) for line in r.stdout.splitlines()
            if line and "->" not in line and not line.startswith("NOTE")]

    # the JAX package on the same wavs, in the folder's sorted order
    files = jwavio.list_wavs(str(tmp_path / "in"))
    assert len(snrs) == len(files) == 2
    fs = 16000
    read = [jwavio.read_for_processing(str(p), fs) for p in files]
    pos = jwavio.read_for_processing(str(tmp_path / "pos.wav"), fs)
    neg = jwavio.read_for_processing(str(tmp_path / "neg.wav"), fs)
    enh = JEnhancer(JConfig.denoiser(), jax_variables(DENOISER_NPZ),
                    out_wire="float32")
    ref = enh.enhance_batch(read, [pos] * 2, [neg] * 2)
    ref_dir = tmp_path / "ref"
    for i, path in enumerate(files):
        name = os.path.basename(path)
        base = name[:-4]
        den, rem = ref["denoised"][i], ref["removed"][i]
        want = {name: den, f"{base}_mixed_processed.wav":
                ref["mixed_processed"][i],
                f"{base}_removed.wav": rem,
                f"{base}_compensated.wav": enh.compensate(
                    den, rem, float(ref["snr_est"][i]), 0.25)}
        for fname, x in want.items():
            jwavio.write_wav(str(ref_dir / fname), x, fs)
            got = _read(out_dir / fname)
            expect = _read(ref_dir / fname)
            assert got.shape == expect.shape, fname
            np.testing.assert_allclose(got, expect, atol=WAVE_ATOL,
                                       err_msg=fname)
        np.testing.assert_allclose(snrs[i], ref["snr_est"][i], rtol=SNR_RTOL)


def test_separator_single_file_matches_jax_in_slot_order(tmp_path):
    (mixed,) = _seeded_wavs(tmp_path, 12, [0.6])
    out = tmp_path / "sep.wav"
    r = _cli("separator", "--device", "cpu", "--checkpoint", SEPARATOR_NPZ,
             "--input", str(mixed), "--pos", str(tmp_path / "pos.wav"),
             "--neg", str(tmp_path / "neg.wav"), "--output", str(out))
    assert r.returncode == 0, r.stderr
    fs = 16000
    x, target, interference = (
        jwavio.read_for_processing(str(p), fs)
        for p in (mixed, tmp_path / "pos.wav", tmp_path / "neg.wav"))
    # the separator's slots: (interference = --neg, target = --pos)
    ref = JEnhancer(JConfig.separator(), jax_variables(SEPARATOR_NPZ),
                    out_wire="float32").enhance(x, interference, target)
    for fname, key in (("sep.wav", "denoised"),
                       ("sep_mixed_processed.wav", "mixed_processed"),
                       ("sep_removed.wav", "removed")):
        np.testing.assert_allclose(_read(tmp_path / fname),
                                   ref[key].astype(np.float32),
                                   atol=WAVE_ATOL, err_msg=fname)
    assert not (tmp_path / "sep_compensated.wav").exists()


def test_demo_mixes_first_as_jax_does(tmp_path):
    """--demo takes --input as clean speech, mixes it with the contexts at
    0 dB (demo_mix) and enhances the mixture."""
    (clean,) = _seeded_wavs(tmp_path, 13, [0.55])
    out = tmp_path / "demo.wav"
    task, npz = "denoiser", DENOISER_NPZ
    r = _cli(task, "--device", "cpu", "--checkpoint", npz, "--demo",
             "--input", str(clean), "--pos", str(tmp_path / "pos.wav"),
             "--neg", str(tmp_path / "neg.wav"), "--output", str(out))
    assert r.returncode == 0, r.stderr
    fs = 16000
    x, pos, neg = (jwavio.read_for_processing(str(p), fs)
                   for p in (clean, tmp_path / "pos.wav",
                             tmp_path / "neg.wav"))
    cfg = JConfig.denoiser()
    mixed = j_demo_mix(cfg, task, x, pos, neg)
    ref = JEnhancer(cfg, jax_variables(npz), out_wire="float32").enhance(
        mixed, pos, neg)
    for fname, key in (("demo.wav", "denoised"),
                       ("demo_mixed_processed.wav", "mixed_processed"),
                       ("demo_removed.wav", "removed")):
        np.testing.assert_allclose(_read(tmp_path / fname),
                                   ref[key].astype(np.float32),
                                   atol=WAVE_ATOL, err_msg=fname)


def test_freq_pad_up_to_the_bins_serves_natively(tmp_path):
    """NHANS_FREQ_PAD up to 201 selects nothing in the JAX package, so
    the port serves as it does without it: within 1e-4 (the CPU
    convolutions' threading moves a run by about 2e-7; a padded tower
    geometry would move it by far more)."""
    (mixed,) = _seeded_wavs(tmp_path, 14, [0.5])
    outs = {}
    for pad in ("", "128"):
        out = tmp_path / f"out{pad or 'plain'}.wav"
        r = _cli("denoiser", "--device", "cpu", "--checkpoint", DENOISER_NPZ,
                 "--input", str(mixed), "--neg", str(tmp_path / "neg.wav"),
                 "--output", str(out), env={"NHANS_FREQ_PAD": pad})
        assert r.returncode == 0, r.stderr
        outs[pad] = _read(out)
    np.testing.assert_allclose(outs["128"], outs[""], atol=WAVE_ATOL)


def test_recon_residual_cap_zero_is_honoured(tmp_path):
    """The head's bias is rigged to predict +12 nats at bin 0, the
    low-bin blowup the cap bounds: with --recon_residual_cap 0 the port's
    command line gives the JAX Enhancer built with recon_residual_cap=0.0
    (the JAX command line drops the flag).  The output peaks at more than
    100 times the mixture's, far beyond the e^2 gain the default cap of 2
    nats allows: the cap would have bitten."""
    with np.load(DENOISER_NPZ) as z:
        flat = {k: z[k] for k in z.files}
    b = flat["params/last_dense/b"].astype(np.float32)
    b[0] = 12.0
    flat["params/last_dense/b"] = b
    rigged = str(tmp_path / "rigged.npz")
    np.savez(rigged, **flat)
    (mixed,) = _seeded_wavs(tmp_path, 15, [0.5])
    out = tmp_path / "uncapped.wav"
    r = _cli("denoiser", "--device", "cpu", "--checkpoint", rigged,
             "--recon_residual_cap", "0", "--input", str(mixed),
             "--neg", str(tmp_path / "neg.wav"), "--output", str(out))
    assert r.returncode == 0, r.stderr
    fs = 16000
    x = jwavio.read_for_processing(str(mixed), fs)
    neg = jwavio.read_for_processing(str(tmp_path / "neg.wav"), fs)
    pos = np.zeros(fs)
    cfg = JConfig.denoiser()
    uncapped_cfg = cfg.replace(audio=dataclasses.replace(
        cfg.audio, recon_residual_cap=0.0))
    ref = JEnhancer(uncapped_cfg, jax_variables(rigged),
                    out_wire="float32").enhance(x, pos, neg)
    want = ref["denoised"]
    assert np.abs(want).max() > 100 * np.abs(ref["mixed_processed"]).max()
    got = _read(out)
    np.testing.assert_allclose(got, want.astype(np.float32),
                               atol=WAVE_ATOL * np.abs(want).max())
