"""The evaluation golden tests/data/torch_golden_eval.npz (written by
``python tests/make_torch_golden.py eval``): the JAX package's Evaluator
at full width with the shipped denoiser on two seeded utterances, which
chip_smoke.py holds the port to on the card.  Here the inputs still
regenerate, and the port's Evaluator on the CPU gives the same metric
keys, eval_loss within 1e-5 relative, SI-SDR within 1e-3 dB, STOI and
ESTOI within 1e-4, PESQ within 1e-3, each utterance's mean window loss
within 1e-4 relative and the denoised waveforms within 1e-4.  The losses
are the least precise: two float32 DFTs that sum in different orders
(MKL for the port's plain spectrogram, XLA for the JAX one) differ at
bins of small magnitude, and the loss squares log-magnitude differences
there (eval_loss 5e-6 relative, one utterance's loss 8.8e-6, on a CPU
with 1 and 3 threads)."""

import numpy as np
import pytest

from tests.make_torch_golden import (EVAL_SEED, GOLDEN_EVAL, eval_digest,
                                     golden_eval_examples, port_eval_golden)

TOL = {"eval_loss": ("rel", 1e-5), "si_sdr": ("abs", 1e-3),
       "si_sdr_mixed": ("abs", 1e-3), "si_sdr_gain": ("abs", 1e-3),
       "stoi": ("abs", 1e-4), "stoi_mixed": ("abs", 1e-4),
       "estoi": ("abs", 1e-4), "estoi_mixed": ("abs", 1e-4),
       "pesq": ("abs", 1e-3)}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN_EVAL) as z:
        return {k: z[k] for k in z.files}


def test_eval_golden_inputs_regenerate(golden):
    examples = golden_eval_examples()
    assert int(golden["seed"]) == EVAL_SEED
    assert str(golden["input_sha256"]) == eval_digest(examples)
    for key in ("snr_a", "snr_b", "clean_len"):
        np.testing.assert_array_equal(golden[key],
                                      [ex[key] for ex in examples])
    # every score was reported: the utterances are long enough for STOI
    assert set(TOL) == {k[len("metric/"):] for k in golden
                        if k.startswith("metric/")}


def test_port_evaluator_reproduces_eval_golden_on_cpu(golden):
    got = port_eval_golden("cpu")
    assert set(got) == {k for k in golden
                        if k.startswith(("metric/", "utt/", "denoised_"))}
    for name, (kind, tol) in TOL.items():
        g, w = got[f"metric/{name}"], float(golden[f"metric/{name}"])
        bar = tol * abs(w) if kind == "rel" else tol
        assert abs(g - w) <= bar, (name, g, w)
    np.testing.assert_allclose(got["utt/loss"], golden["utt/loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["utt/si_sdr"], golden["utt/si_sdr"],
                               atol=1e-3)
    for name, tol in (("stoi", 1e-4), ("estoi", 1e-4), ("pesq", 1e-3)):
        np.testing.assert_allclose(got[f"utt/{name}"], golden[f"utt/{name}"],
                                   atol=tol, err_msg=name)
    for i in range(2):
        np.testing.assert_allclose(got[f"denoised_{i}"],
                                   golden[f"denoised_{i}"], atol=1e-4)
