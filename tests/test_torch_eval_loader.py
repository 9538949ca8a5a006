"""The port's EvalLoader against the JAX package's on one temporary
corpus: the denoiser and the separator, `wrap` and `queue` pairing, with
and without `limit`, with the thread pool and without.  Every field must
match: paths, SNRs (the md5 of the clean path), lengths and whole-file
peaks equal, samples bit-equal."""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from nhans_tpu.data.loader import EvalLoader as JEvalLoader
from nhans_tpu_torch.data.loader import EvalLoader
from nhans_tpu_torch.data.manifest import create_seeds
from tests.make_torch_golden import twin_configs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """7 valid speech files and 5 valid noises of 0.3 to 1.4 s; one
    speech file is longer than max_samples, so its buffer is cut and its
    peak (at its end) lies past the cut."""
    root = tmp_path_factory.mktemp("eval_corpus")
    rng = np.random.default_rng(11)
    dirs = []
    for kind, n in (("speech", 7), ("noise", 5)):
        base = os.path.join(str(root), kind)
        for split in ("train", "valid", "test"):
            os.makedirs(os.path.join(base, split))
        for i in range(n):
            x = rng.standard_normal(int((0.3 + 0.17 * i) * 16000)) * (
                900 + 200 * i)
            if kind == "speech" and i == 6:
                x[-1] = 31000.0
            wavfile.write(os.path.join(base, "valid", f"{kind}{i}.wav"),
                          16000, np.rint(x).astype(np.int16))
        wavfile.write(os.path.join(base, "train", "t.wav"), 16000,
                      np.zeros(800, np.int16))
        create_seeds(base)
        dirs.append(base + "/")
    return dirs


@pytest.mark.parametrize("task", ["denoiser", "separator"])
@pytest.mark.parametrize("pairing", ["wrap", "queue"])
@pytest.mark.parametrize("limit, workers", [(None, 3), (4, 1), (2, 3)])
def test_eval_loader_equals_jax(corpus, task, pairing, limit, workers):
    jcfg, tcfg = twin_configs(task, data=dict(
        speech_wav_dir=corpus[0], noise_wav_dir=corpus[1],
        eval_pairing=pairing, max_samples=18000))
    want = list(JEvalLoader(jcfg, limit=limit, num_workers=workers))
    got = list(EvalLoader(tcfg, limit=limit, num_workers=workers))
    assert want, "the plan is empty"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    if pairing == "wrap":
        assert len(got) == (limit or 7)
    cut = [e for e in got if e["cleanpath"].endswith("speech6.wav")]
    for e in cut:
        assert e["clean_len"] == 18000 and e["peaks"][0] == 31000.0
