"""Typed configuration of the PyTorch port (serving half).

A copy of the serving fields of ``nhans_tpu/config.py``: the audio
front end, the model architecture and the two task configurations.  The
data and training configurations come with the training slice of the
port.  The port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Audio front end: 16 kHz, 25 ms frames, 10 ms hop, 400-point DFT,
    201 bins."""

    sample_rate: int = 16000
    frame_ms: float = 25.0
    hop_ms: float = 10.0
    log_eps: float = 1e-5  # log(|X| + 1e-5)
    # Reconstruction-only cap (nats) on the predicted per-bin log-magnitude
    # residual; <= 0 disables.  A bin may be amplified at most e^cap times
    # the mixture's magnitude, suppression stays unbounded.  The training
    # loss never sees it.
    recon_residual_cap: float = 2.0

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_ms / 1000.0)  # 400

    @property
    def frame_step(self) -> int:
        return int(self.sample_rate * self.hop_ms / 1000.0)  # 160

    @property
    def fft_length(self) -> int:
        return self.frame_length

    @property
    def num_features(self) -> int:
        return self.fft_length // 2 + 1  # 201

    def num_frames(self, num_samples: int) -> int:
        """Number of full STFT frames for a signal of ``num_samples``."""
        if num_samples < self.frame_length:
            return 0
        return 1 + (num_samples - self.frame_length) // self.frame_step

    def trim_to_whole_frames(self, num_samples: int) -> int:
        """Length after cutting the tail to a whole number of frames."""
        rem = (num_samples - self.frame_length) % self.frame_step
        return num_samples - rem if rem else num_samples


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the conditional ResNet."""

    window_frames: int = 35
    context_frames: int = 200
    num_features: int = 201
    embedding_dim: int = 512
    bn_eps: float = 1e-3
    pos_embed_hidden: int = 50
    # Main tower: (kernel, stride, channels) per block.
    main_blocks: Sequence = (
        (4, 1, 64), (4, 1, 64),
        (4, 2, 128), (4, 1, 128),
        (3, 2, 256), (3, 1, 256),
        (3, 2, 512), (3, 1, 512),
    )
    # Context tower: (kernel_hw, stride_hw, channels).
    context_blocks: Sequence = (
        ((8, 4), (3, 2), 64),
        ((8, 4), (3, 2), 128),
        ((4, 4), (1, 1), 256),
        ((4, 4), (1, 2), 512),
    )
    # Lane-padded tower geometry of the JAX package; the port supports
    # only the native geometry (0) so far.
    freq_pad_to: int = 0


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """``denoiser``: contexts are (positive noise, negative noise).
    ``separator``: contexts are (interference speaker, target speaker)."""

    name: str = "denoiser"

    @staticmethod
    def denoiser() -> "TaskConfig":
        return TaskConfig(name="denoiser")

    @staticmethod
    def separator() -> "TaskConfig":
        return TaskConfig(name="separator")


@dataclasses.dataclass(frozen=True)
class Config:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    task: TaskConfig = dataclasses.field(default_factory=TaskConfig)

    @staticmethod
    def denoiser(**overrides) -> "Config":
        return Config(task=TaskConfig.denoiser(), **overrides)

    @staticmethod
    def separator(**overrides) -> "Config":
        return Config(task=TaskConfig.separator(), **overrides)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def add_inference_flags(parser, task: str = "denoiser") -> None:
    """Register the serving flags of the reference toolkit's CLIs on an
    argparse parser, plus ``--device``."""
    defaults = {
        "denoiser": dict(input="./audio_examples/mixed.wav",
                         neg="./audio_examples/game_noise.wav",
                         pos="./audio_examples/Silent.wav",
                         output="./audio_examples/denoised.wav"),
        "separator": dict(input="./audio_examples/mixed.wav",
                          neg="./audio_examples/noise_speaker.wav",
                          pos="./audio_examples/target_speaker.wav",
                          output="./audio_examples/separated.wav"),
    }[task]
    parser.add_argument("--input", default=defaults["input"],
                        help="mixed wav (or a directory of wavs)")
    parser.add_argument("--neg", default=defaults["neg"],
                        help="negative/interference recording")
    parser.add_argument("--pos", default=defaults["pos"],
                        help="positive/target recording")
    parser.add_argument("--output", default=defaults["output"],
                        help="output wav (or directory in folder mode)")
    parser.add_argument("--compensate", type=float, default=0.0,
                        help="energy compensation factor")
    parser.add_argument("--ac", action="store_true", default=False,
                        help="auto compensation from the SNR estimate")
    parser.add_argument("--checkpoint", default="",
                        help="weights as a flat .npz of flax-layout "
                             "params/batch_stats (e.g. "
                             "docs/quality/denoiser_q5_swa.npz)")
    parser.add_argument("--demo", action="store_true", default=False,
                        help="treat --input as CLEAN speech and mix it "
                             "with --pos/--neg first (not ported yet)")
    parser.add_argument("--recon_residual_cap", type=float, default=2.0,
                        help="reconstruction-only cap (nats) on the "
                             "predicted per-bin log-magnitude gain over "
                             "the mixture; 0 disables")
    parser.add_argument("--Fs", type=int, default=16000,
                        help="rate wavs are read (resampled) and written at")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda; "
                             "'cpu' runs the plain PyTorch path)")
