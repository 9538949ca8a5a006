"""The port's own copy of the wav IO against nhans_tpu.utils.wavio, and the
one place where it departs: a stereo int16 file at another rate, which
the JAX copy downmixes before scaling (to float) and so saturates."""

import numpy as np
import pytest
from scipy.io import wavfile

from nhans_tpu.utils import wavio as J
from nhans_tpu_torch.utils import wavio as T


def _tone(rate, seconds=0.25, channels=1):
    t = np.arange(int(rate * seconds)) / rate
    x = 0.4 * np.sin(2 * np.pi * 440 * t)
    return np.stack([x, 0.5 * x], axis=1) if channels == 2 else x


@pytest.mark.parametrize("rate,dtype,channels", [
    (16000, np.int16, 1), (16000, np.int16, 2), (8000, np.int16, 1),
    (44100, np.float32, 2), (22050, np.int32, 1), (16000, np.uint8, 1),
])
def test_read_for_processing_matches_jax(tmp_path, rate, dtype, channels):
    x = _tone(rate, channels=channels)
    scale = {np.int16: 32767, np.int32: 2 ** 31 - 1, np.uint8: 127,
             np.float32: 1.0}[dtype]
    data = x * scale + (128 if dtype == np.uint8 else 0)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, rate, data.astype(dtype))
    got = T.read_for_processing(path)
    np.testing.assert_array_equal(got, J.read_for_processing(path))
    assert got.dtype == np.float64


def test_stereo_int16_at_another_rate_is_scaled_before_downmix(tmp_path):
    x = _tone(48000, channels=2)
    path = str(tmp_path / "s.wav")
    wavfile.write(path, 48000, (x * 32767).astype(np.int16))
    got = T.read_for_processing(path)
    mono = str(tmp_path / "m.wav")
    wavfile.write(mono, 48000, (x.mean(axis=1) * 32767).astype(np.int16))
    want = T.read_for_processing(mono)
    assert np.abs(got - want).max() <= 2.0          # int16 rounding
    assert np.abs(got).max() < 0.5 * 32767          # not saturated


def test_strict_reader_refuses_other_formats(tmp_path):
    path = str(tmp_path / "f.wav")
    wavfile.write(path, 8000, np.zeros(100, np.int16))
    with pytest.raises(ValueError, match="16000 Hz"):
        T.read_wav_strict(path)
    wavfile.write(path, 16000, np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="int16"):
        T.read_for_processing(path, strict=True)


def test_write_wav_is_float32(tmp_path):
    path = str(tmp_path / "sub" / "o.wav")
    T.write_wav(path, np.linspace(-1, 1, 50))
    rate, y = wavfile.read(path)
    assert rate == 16000 and y.dtype == np.float32 and len(y) == 50
