"""Quality scores of the evaluator: SI-SDR, SDR, log-spectral distance,
STOI, ESTOI and PESQ, in numpy and scipy.  The port's copy of
``nhans_tpu/utils/scoring.py``, kept so that the port never imports the
JAX package (importing any ``nhans_tpu`` module imports JAX).
"""

from __future__ import annotations

import numpy as np

from nhans_tpu_torch.utils.pesq_np import pesq_np


def _align(est: np.ndarray, ref: np.ndarray):
    n = min(len(est), len(ref))
    return np.asarray(est[:n], np.float64), np.asarray(ref[:n], np.float64)


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR in dB (Le Roux et al., 2019)."""
    est, ref = _align(est, ref)
    ref_energy = np.sum(ref ** 2) + 1e-12
    proj = (np.sum(est * ref) / ref_energy) * ref
    noise = est - proj
    return float(10 * np.log10((np.sum(proj ** 2) + 1e-12)
                               / (np.sum(noise ** 2) + 1e-12)))


def sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Plain SDR in dB."""
    est, ref = _align(est, ref)
    noise = est - ref
    return float(10 * np.log10((np.sum(ref ** 2) + 1e-12)
                               / (np.sum(noise ** 2) + 1e-12)))


def lsd(est: np.ndarray, ref: np.ndarray, frame_length: int = 400,
        frame_step: int = 160) -> float:
    """Log-spectral distance (dB RMS over frames/bins)."""
    est, ref = _align(est, ref)

    def spec(x):
        nf = 1 + (len(x) - frame_length) // frame_step
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_length)
                               / frame_length)
        frames = np.stack([x[i * frame_step:i * frame_step + frame_length] * w
                           for i in range(nf)])
        return 20 * np.log10(np.abs(np.fft.rfft(frames, axis=-1)) + 1e-8)

    a, b = spec(est), spec(ref)
    n = min(len(a), len(b))
    return float(np.sqrt(np.mean((a[:n] - b[:n]) ** 2)))


def snr_improvement(mixed: np.ndarray, est: np.ndarray,
                    ref: np.ndarray) -> float:
    """SI-SDR(est, ref) - SI-SDR(mixed, ref): the enhancement gain."""
    return si_sdr(est, ref) - si_sdr(mixed, ref)


# --------------------------------------------------------------------- #
# STOI (Taal et al., 2011): short-time objective intelligibility.
# --------------------------------------------------------------------- #

_STOI_FS = 10000
_STOI_FRAME = 256       # 25.6 ms at 10 kHz
_STOI_HOP = 128
_STOI_NFFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_SEG = 30          # analysis segment length (frames) ~ 384 ms
_STOI_BETA = -15.0      # lower SDR clip bound (dB)
_STOI_DYN = 40.0        # silent-frame energy range (dB)


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    """One-third octave band matrix [num_bands, nfft//2+1]."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_i:hi_i] = 1.0
    return obm, cf


def _stoi_frames(x: np.ndarray):
    if len(x) < _STOI_FRAME:
        return np.zeros((0, _STOI_FRAME))
    n = 1 + (len(x) - _STOI_FRAME) // _STOI_HOP
    idx = (np.arange(n)[:, None] * _STOI_HOP
           + np.arange(_STOI_FRAME)[None, :])
    w = np.hanning(_STOI_FRAME + 2)[1:-1]
    return x[idx] * w


def stoi(est: np.ndarray, ref: np.ndarray, fs: int = 16000) -> float:
    """Short-time objective intelligibility in [~0, 1] (Taal et al. 2011;
    ``ref`` is the clean signal).  Signals are resampled to 10 kHz, silent
    clean frames removed, 1/3-octave band envelopes compared over 384 ms
    segments with normalization + SDR clipping."""
    X, Y = _stoi_band_envelopes(est, ref, fs)
    if X is None:
        return float("nan")
    # X, Y: [bands, frames]

    N = _STOI_SEG
    c = 10 ** (-_STOI_BETA / 20.0)
    scores = []
    for m in range(N, X.shape[1] + 1):
        Xs = X[:, m - N:m]                       # [bands, N]
        Ys = Y[:, m - N:m]
        alpha = (np.linalg.norm(Xs, axis=1, keepdims=True)
                 / (np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12))
        Yp = np.minimum(Ys * alpha, Xs * (1 + c))
        xm = Xs - Xs.mean(axis=1, keepdims=True)
        ym = Yp - Yp.mean(axis=1, keepdims=True)
        num = np.sum(xm * ym, axis=1)
        den = (np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1)
               + 1e-12)
        scores.append(num / den)
    return float(np.mean(scores))


def _stoi_band_envelopes(est: np.ndarray, ref: np.ndarray, fs: int):
    """Shared STOI/ESTOI front-end: resample to 10 kHz, frame, drop
    silent clean frames, 1/3-octave band magnitudes [bands, frames]."""
    from scipy.signal import resample_poly

    est, ref = _align(est, ref)
    if fs != _STOI_FS:
        g = np.gcd(int(fs), _STOI_FS)
        est = resample_poly(est, _STOI_FS // g, fs // g)
        ref = resample_poly(ref, _STOI_FS // g, fs // g)
    xf = _stoi_frames(ref)
    yf = _stoi_frames(est)
    if len(xf) < _STOI_SEG:
        return None, None
    e = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = e > (e.max() - _STOI_DYN)
    xf, yf = xf[keep], yf[keep]
    if len(xf) < _STOI_SEG:
        return None, None
    obm, _ = _thirdoct(_STOI_FS, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    X = np.sqrt(obm @ (np.abs(np.fft.rfft(xf, _STOI_NFFT, axis=1)).T ** 2))
    Y = np.sqrt(obm @ (np.abs(np.fft.rfft(yf, _STOI_NFFT, axis=1)).T ** 2))
    return X, Y


def estoi(est: np.ndarray, ref: np.ndarray, fs: int = 16000) -> float:
    """Extended STOI (Jensen & Taal, 2016): spectral-correlation variant
    robust to modulated maskers.  Same 1/3-octave front-end as STOI; per
    384 ms segment, rows (bands) then columns (frames) are mean/norm
    normalized and the mean column correlation is averaged."""
    X, Y = _stoi_band_envelopes(est, ref, fs)
    if X is None:
        return float("nan")
    N = _STOI_SEG
    scores = []
    for m in range(N, X.shape[1] + 1):
        Xs = X[:, m - N:m]
        Ys = Y[:, m - N:m]

        def norm_rows(a):
            a = a - a.mean(axis=1, keepdims=True)
            return a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-12)

        def norm_cols(a):
            a = a - a.mean(axis=0, keepdims=True)
            return a / (np.linalg.norm(a, axis=0, keepdims=True) + 1e-12)

        Xn = norm_cols(norm_rows(Xs))
        Yn = norm_cols(norm_rows(Ys))
        scores.append(np.sum(Xn * Yn) / N)
    return float(np.mean(scores))


def pesq_score(est: np.ndarray, ref: np.ndarray, fs: int = 16000):
    """PESQ (ITU-T P.862) MOS-LQO, or None where it cannot be computed.
    The conformant C ``pesq`` package is taken when it is installed;
    otherwise the numpy P.862 pipeline of ``utils/pesq_np.py``."""
    est, ref = _align(est, ref)
    mode = "wb" if fs == 16000 else "nb"
    try:
        from pesq import pesq as _pesq
        return float(_pesq(fs, ref, est, mode))
    except ImportError:
        pass
    except Exception:
        return None
    try:
        return pesq_np(fs, ref, est, mode)
    except Exception:
        return None
