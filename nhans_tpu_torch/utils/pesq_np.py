"""Pure-numpy PESQ (ITU-T P.862 perceptual model), narrowband and
wideband: the port's copy of ``nhans_tpu/utils/pesq_np.py``, kept so that
the port never imports the JAX package.

The P.862 psychoacoustic pipeline, from the standard:

  level alignment -> (IRS / wideband) input filter -> time alignment ->
  32 ms / 50%-overlap power spectra -> Bark-band warping -> frequency
  equalization -> per-frame gain equalization -> Zwicker loudness ->
  disturbance with masking deadzone -> asymmetry weighting -> L6/L2
  aggregation -> raw PESQ score -> MOS-LQO mapping (P.862.1 narrowband /
  P.862.2 wideband).

Divergences from the letter of the standard (a re-derivation of the
P.862 pipeline, not a port of the ITU reference C code):

* Time alignment: one GLOBAL delay from envelope cross-correlation
  instead of the standard's utterance splitting + iterative
  re-alignment.  Exact for the evaluator's pairs (reconstructions are
  sample-aligned with their references by construction) and for any
  constant-delay pair; variable-delay telephony recordings would score
  pessimistically.
* Band tables: the Bark ladder, absolute-threshold curve and Zwicker
  exponents are computed from their defining formulas (Zwicker/Terhardt)
  rather than copied from the standard's printed tables; placements
  agree to within a band width.
* The MOS-LQO output mappings are the published P.862.1/P.862.2
  coefficients.

Use: ranking and monotonic quality comparison.  Scores track, but are
not bit-identical to, the ITU reference implementation.  When a
conformant `pesq` package is installed it takes precedence
(``utils/scoring.py::pesq_score``).
"""

from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------
# Bark scale helpers (P.862 uses 49 bands at 16 kHz wideband, 42 at 8 kHz)

_NB_BANDS = 42
_WB_BANDS = 49
_SP_NB = 6.910853e-006
_SP_WB = 6.910853e-006 * 1.20  # wideband power scaling (P.862.2 annex)
_SL_NB = 1.866055e-001
_SL_WB = 1.866055e-001 * 1.20

# Center frequencies (Hz) of the Bark bands, reproduced from the
# standard's tables (identical ladders; wideband extends to 8 kHz).


def _bark_centres(n_bands: int, fs: int) -> np.ndarray:
    """Bark-spaced centre frequencies: a uniform ladder in Bark up to
    (fs/2 - 100) Hz inverted through the Zwicker Hz->Bark formula.
    (The standard ships these as literal tables; this derives the same
    ladder analytically — band placement agrees to within a band width.)
    """
    zs = (np.arange(n_bands) + 0.5) / n_bands * _hz2bark(
        np.asarray([fs / 2.0 - 100.0]))[0]
    f = np.linspace(10.0, fs / 2.0, 20000)
    zf = _hz2bark(f)
    return np.interp(zs, zf, f)


def _hz2bark(f: np.ndarray) -> np.ndarray:
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _band_edges(n_bands: int, fs: int) -> np.ndarray:
    zmax = _hz2bark(np.asarray([fs / 2.0 - 100.0]))[0]
    zs = np.arange(n_bands + 1) / n_bands * zmax
    f = np.linspace(10.0, fs / 2.0, 20000)
    zf = _hz2bark(f)
    return np.interp(zs, zf, f)


# Absolute hearing threshold (dB SPL) vs frequency (Terhardt approximation,
# which the standard's threshold table follows).
def _abs_thresh_power(fc: np.ndarray) -> np.ndarray:
    f = np.maximum(fc, 20.0) / 1000.0
    db = (3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
          + 1e-3 * f ** 4)
    db = np.clip(db, -10.0, 96.0)
    return 10.0 ** (db / 10.0)


# "Modified Zwicker power" per band (standard: 0.23 nominal with a
# low-frequency correction term).
def _zwicker_power(fc: np.ndarray) -> np.ndarray:
    p = np.full(fc.shape, 0.23)
    lo = fc < 1000.0
    p[lo] = 0.23 + 0.00002 * (1000.0 - fc[lo])
    return p


# ----------------------------------------------------------------------


def _frame_powers(x: np.ndarray, fs: int, n_bands: int) -> np.ndarray:
    """Hann-windowed 32 ms / 50 % overlap power spectra folded into Bark
    bands.  Returns [n_frames, n_bands] band powers."""
    nfft = 512 if fs == 16000 else 256
    hop = nfft // 2
    n = (len(x) - nfft) // hop + 1
    if n <= 0:
        return np.zeros((0, n_bands))
    idx = np.arange(n)[:, None] * hop + np.arange(nfft)[None, :]
    frames = x[idx] * np.hanning(nfft)[None, :]
    spec = np.fft.rfft(frames, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2) / (nfft * nfft)
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    edges = _band_edges(n_bands, fs)
    bands = np.zeros((n, n_bands))
    for b in range(n_bands):
        sel = (freqs >= edges[b]) & (freqs < edges[b + 1])
        if sel.any():
            bands[:, b] = power[:, sel].sum(axis=1)
    # normalize by band width in FFT bins so narrow low bands compare
    # with wide high bands on a density basis (standard's sp normalization)
    widths = np.maximum(np.diff(edges), freqs[1])
    bands = bands / (widths[None, :] / freqs[1])
    return bands


def _level_align(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale to the standard's target active level using 350-3250 Hz band
    power (P.862 level normalization)."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / fs)
    sel = (freqs >= 350.0) & (freqs <= 3250.0)
    p = np.sum(np.abs(spec[sel]) ** 2) / (len(x) ** 2) + 1e-20
    target = 1e4  # corresponds to the standard's 10^7 on 16-bit scale
    return x * np.sqrt(target / p)


def _global_delay(ref: np.ndarray, deg: np.ndarray, fs: int,
                  max_delay_s: float = 0.5) -> int:
    """Envelope cross-correlation delay estimate (crude align stage).

    The search is clamped to +-``max_delay_s`` and the peak must beat the
    zero-lag correlation by a margin — uncorrelated signals (e.g. pure
    noise) otherwise pick an extreme lag and truncate the comparison."""
    hop = fs // 250  # 4 ms envelope
    n = min(len(ref), len(deg)) // hop
    if n < 8:
        return 0
    env = lambda x: np.abs(x[:n * hop]).reshape(n, hop).mean(axis=1)  # noqa
    er, ed = env(ref) - np.mean(env(ref)), env(deg) - np.mean(env(deg))
    corr = np.correlate(ed, er, mode="full")
    zero = n - 1
    w = min(int(max_delay_s * fs) // hop, n - 1)
    window = corr[zero - w:zero + w + 1]
    lag = int(np.argmax(window)) - w
    if window[w + lag] <= 1.05 * window[w]:  # no clear peak over lag 0
        return 0
    return lag * hop


def pesq_np(fs: int, ref: np.ndarray, deg: np.ndarray,
            mode: str = "wb") -> float:
    """PESQ MOS-LQO of ``deg`` against ``ref`` (both 1-D float arrays on
    any consistent scale; int16-range expected).  ``mode``: "wb" (P.862.2
    wideband, 16 kHz) or "nb" (P.862.1 narrowband)."""
    assert fs in (8000, 16000), fs
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    n_bands = _WB_BANDS if fs == 16000 else _NB_BANDS
    sp = _SP_WB if mode == "wb" else _SP_NB
    sl = _SL_WB if mode == "wb" else _SL_NB

    # --- alignment (global delay; see module docstring)
    d = _global_delay(ref, deg, fs)
    if d > 0:
        deg = deg[d:]
    elif d < 0:
        ref = ref[-d:]
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]

    # --- perceptual transform
    br = _frame_powers(ref, fs, n_bands)
    bd = _frame_powers(deg, fs, n_bands)
    if len(br) == 0 or len(bd) == 0:
        return 1.0
    nf = min(len(br), len(bd))
    br, bd = br[:nf], bd[:nf]
    fc = _bark_centres(n_bands, fs)
    thresh = _abs_thresh_power(fc)  # 10^(dB/10), 0 dB floor reference
    gamma = _zwicker_power(fc)

    # --- level alignment in the band domain: scale each signal so its
    # active-speech-band (350-3250 Hz) mean power sits at 10^7 — i.e.
    # ~70 dB above the absolute-threshold curve's reference, the
    # standard's calibrated listening level.
    speech_sel = (fc >= 350.0) & (fc <= 3250.0)

    def level(bands):
        fe = bands.sum(axis=1)
        aud = fe > np.mean(fe) * 1e-2
        if not aud.any():
            aud = np.ones(len(bands), bool)
        m = bands[aud][:, speech_sel].mean() + 1e-20
        return bands * (1e7 / m), aud

    br, aud_r = level(br)
    bd, _ = level(bd)
    frame_e = br.sum(axis=1)

    # frequency (transfer-function) equalization: per-band ratio of mean
    # degraded to mean reference power over audible frames, clamped to
    # +-20 dB — and gated to bands the reference genuinely excites
    # (mean power > 100x absolute threshold, the standard's condition):
    # near-silent reference bands must not be lifted to meet additive
    # noise, which is distortion, not transfer function.
    num = bd[aud_r].mean(axis=0) + 1e3
    den = br[aud_r].mean(axis=0) + 1e3
    eq = np.clip(num / den, 1e-2, 1e2)
    eq = np.where(br[aud_r].mean(axis=0) > 100.0 * thresh, eq, 1.0)
    br_eq = br * eq[None, :]

    # per-frame gain equalization (clamped to ~+-5 dB, smoothed in time
    # as the standard filters short-term gain)
    gnum = br_eq.sum(axis=1) + 5e4
    gden = bd.sum(axis=1) + 5e4
    g = np.clip(gnum / gden, 3e-1, 3.0)
    for i in range(1, nf):
        g[i] = 0.8 * g[i - 1] + 0.2 * g[i]
    bd_eq = bd * g[:, None]

    # --- loudness (Zwicker law around the absolute threshold)
    def loudness(bands):
        ratio = (thresh[None, :] / 0.5) ** gamma[None, :]
        term = (0.5 + 0.5 * bands / thresh[None, :]) ** gamma[None, :] - 1.0
        return sl * ratio * np.maximum(term, 0.0)

    lr = loudness(br_eq)
    ld = loudness(bd_eq)

    # --- disturbance with masking deadzone
    diff = ld - lr
    dead = 0.25 * np.minimum(np.abs(ld), np.abs(lr))
    disturb = np.sign(diff) * np.maximum(np.abs(diff) - dead, 0.0)

    # asymmetry factor: additive distortion (deg > ref) is weighted UP
    # relative to component loss, per band power ratio^1.2 (standard's
    # asymmetric disturbance)
    ratio = (bd_eq + 50.0) / (br_eq + 50.0)
    asym = np.clip(ratio ** 1.2, 0.0, 12.0)
    asym[asym < 3.0] = 0.0
    d_asym = disturb * asym

    # --- aggregation: width-weighted L2 over bark bands per frame, then
    # L6 over ~320 ms intervals, then L2 over intervals
    widths = np.diff(_band_edges(n_bands, fs))
    wnorm = widths / widths.sum()

    def frame_norm(dist, p=2.0):
        return (np.sum((np.abs(dist) ** p) * wnorm[None, :],
                       axis=1)) ** (1.0 / p)

    def time_agg(frame_d):
        # de-emphasize silent frames (standard weights by frame energy)
        w = ((frame_e + 1e5) / 1e7) ** 0.04
        fd = frame_d / w
        span = 20  # frames per interval (~320 ms)
        nint = max(nf // span, 1)
        ints = np.asarray([
            np.mean(fd[i * span:(i + 1) * span] ** 6.0) ** (1.0 / 6.0)
            for i in range(nint)])
        return float(np.sqrt(np.mean(ints ** 2.0)))

    d_sym_t = time_agg(frame_norm(disturb))
    d_asym_t = time_agg(frame_norm(d_asym, p=1.0))

    # Raw score: the standard's 0.1 / 0.0309 sym/asym weighting, with a
    # power-law calibration (fitted on synthetic additive-noise SNR
    # ladders) that maps this pipeline's disturbance scale onto the
    # conformant implementation's typical MOS range — identity ~4.6,
    # SNR 0 dB ~2, pure noise ~1.5, monotone in between.
    penalty = 0.1 * d_sym_t + 0.0309 * d_asym_t
    raw = 4.5 - 3.62 * penalty ** 0.407
    # MOS-LQO mapping
    if mode == "wb":
        # P.862.2: max MOS-LQO 4.64 at raw 4.5
        mos = 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    else:
        # P.862.1: max MOS-LQO 4.55 at raw 4.5
        mos = 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))
    return float(np.clip(mos, 1.0, 5.0))
