"""Signal processing: STFT / iSTFT with tf.signal semantics, the SNR
mixing of the training batch, and frame-axis windowing."""

from nhans_tpu_torch.dsp.spectral import (
    hann_window,
    synthesis_window,
    frame_signal,
    stft,
    stft_magphase,
    log_magnitude,
    spectrogram,
    istft,
    istft_from_logmag,
    overlap_add,
)
from nhans_tpu_torch.dsp.mixing import (
    peak_normalize,
    loop_or_trim,
    mixing_gains,
    mix_two_noise,
    mix_one_noise,
    snr_index_from_path,
)
from nhans_tpu_torch.dsp.windowing import (
    pad_for_windowing,
    strided_windows,
    rest_crop_indices,
)

__all__ = [
    "hann_window", "synthesis_window", "frame_signal", "stft",
    "stft_magphase", "log_magnitude", "spectrogram", "istft",
    "istft_from_logmag", "overlap_add",
    "peak_normalize", "loop_or_trim", "mixing_gains", "mix_two_noise",
    "mix_one_noise", "snr_index_from_path",
    "pad_for_windowing", "strided_windows", "rest_crop_indices",
]
