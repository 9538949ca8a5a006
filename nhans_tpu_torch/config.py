"""Typed configuration of the PyTorch port.

A copy of ``nhans_tpu/config.py``: the audio front end, the model
architecture, the two task configurations, the input pipeline and the
trainer, with the command-line flags that fill them.  Fields
that select TPU machinery (the STFT implementation, donation) are left
out; the mesh axes are the ranks' layout under ``torch.distributed``
(``parallel/``).  The port keeps its own copy so that it never imports
the JAX package.
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
    w_std: float = 0.01            # truncated-normal init of kernels
    b_init: float = 0.0
    bn_decay: float = 0.95         # population EMA of BatchNorm
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
    # Frequency-weighted MSE: linspace(2 -> 1) over the bins.
    loss_weight_hi: float = 2.0
    loss_weight_lo: float = 1.0
    # Compute dtype of the convolutions, matmuls and activations:
    # "float32" or "bfloat16".  Parameters, BatchNorm statistics, the
    # spectrogram, the residual and the loss stay float32.
    compute_dtype: str = "float32"
    # Carry the main tower's frequency axis on this many columns (0 =
    # the native 201): explicit SAME pads from the true width and
    # dead-column masks keep serving outputs those of the native tower;
    # training takes its BatchNorm moments over the padded width.
    freq_pad_to: int = 0
    # Recompute each main-tower block in the backward pass instead of
    # keeping its activations (memory for FLOPs).
    remat: bool = False
    # Training-time Gaussian jitter on both context embeddings, relative
    # to their RMS (0 = off).  Serving never applies it.
    ctx_embed_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """``denoiser``: contexts are (positive noise, negative noise).
    ``separator``: contexts are (interference speaker, target speaker).
    The denoiser mixes clean + positive + negative noise; the separator
    mixes clean + one interfering utterance."""

    name: str = "denoiser"
    snr_set: Sequence[int] = (-3, 0, 3, 5, 8)
    two_noise_mixing: bool = True

    @staticmethod
    def denoiser() -> "TaskConfig":
        return TaskConfig(name="denoiser", snr_set=(-3, 0, 3, 5, 8),
                          two_noise_mixing=True)

    @staticmethod
    def separator() -> "TaskConfig":
        return TaskConfig(name="separator", snr_set=(-5, -3, -1, 0, 1, 3, 5),
                          two_noise_mixing=False)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline."""

    speech_wav_dir: str = "./speech_wav_dir/"
    noise_wav_dir: str = "./noise_wav_dir/"
    eval_seeds: str = "valid"
    # Evaluation pairing of clean and noise files: "wrap" cycles the
    # noises, "queue" stops when they run out (the reference's queues).
    eval_pairing: str = "wrap"
    random_slices: int = 50
    # Crops taken per utterance per training step.
    slices_per_step: int = 4
    # Utterance buffer in samples; (163600 - 400) % 160 == 0.
    max_samples: int = 163600
    # Streaming batches are cut to the smallest of these lengths
    # (seconds) that holds their longest utterance.
    length_buckets: Sequence[float] = (4.0, 7.0, 10.225)
    num_workers: int = 16
    prefetch: int = 2
    seed: int = 0
    # Host -> device wire type of waveforms: "int16" or "float32".
    transfer_dtype: str = "int16"
    # Training-time random circular shift, reversal and polarity of the
    # noise recordings (off by default; the reference has none).
    augment_noise: bool = False
    # Budget (MB) of the streaming loader's cache of decoded files.
    decode_cache_mb: int = 512
    # Append {12, 18, 30} dB to the training SNR set (evaluation keeps
    # the task's set).
    snr_augment: bool = False
    # Corpus resident in device memory: "auto" when it fits
    # device_corpus_mb, "on" (error if it cannot), "off" (stream).
    device_corpus: str = "auto"
    device_corpus_mb: int = 512


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The trainer."""

    alg: str = "sgd"
    lr: float = 0.001
    mom: float = 0.0
    train_mb: int = 64
    eval_mb: int = 100
    batches: int = 3_000_000
    eval_every: int = 5000
    train_monitor_every: int = 1000
    checkpoints_to_keep: int = 1_000_000
    restore_path: str = ""
    model_name: str = "nhans"
    checkpoint_dir: str = "./checkpoints"
    summaries_dir: str = "./summaries"
    dump_results: str = "./dump"
    wav_dump_folder: str = "./wav_dump/"
    eval_before_training: bool = False
    eval_after_training: bool = True
    # Near-clean window loss weight 1 + boost * sigmoid((dist - d) /
    # scale), normalised to mean 1 over the batch (0 = off).
    clean_loss_boost: float = 0.0
    clean_loss_dist: float = 0.25
    clean_loss_scale: float = 0.08
    lr_schedule: str = "constant"  # constant | cosine
    lr_decay_steps: int = 0        # cosine horizon (0 = constant)
    lr_min_frac: float = 0.1       # final lr as a fraction of --lr
    # score the periodic checkpoints on a thread while training goes on
    async_eval: bool = False
    # write a torch.profiler trace of steps 10 to 20 here ("" = off)
    profile_dir: str = ""
    # data-parallel ranks (0 = the world divided by model_axis) and
    # tensor-parallel ranks, which split the wide kernels' output
    # channels (parallel/sharding_rules.py); their product is the world
    data_axis: int = 0
    model_axis: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    task: TaskConfig = dataclasses.field(default_factory=TaskConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

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
                        help="treat --input as CLEAN speech: mix it "
                             "with --pos/--neg at 0 dB first, then "
                             "enhance")
    parser.add_argument("--recon_residual_cap", type=float, default=2.0,
                        help="reconstruction-only cap (nats) on the "
                             "predicted per-bin log-magnitude gain over "
                             "the mixture; 0 disables")
    parser.add_argument("--Fs", type=int, default=16000,
                        help="rate wavs are read (resampled) and written at")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda; "
                             "'cpu' runs the plain PyTorch path)")
    parser.add_argument("--mesh", default="off", choices=("off", "auto"),
                        help="auto: split each batch's rows over the "
                             "largest power of two of visible cards (one "
                             "card: unsplit)")


def add_training_flags(parser) -> None:
    """Register the training flags of the reference toolkit on an argparse
    parser: the names, defaults and help of the JAX package's
    ``add_reference_flags(parser, inference=False)``."""
    import argparse

    # fmt: off
    parser.add_argument("--recon_residual_cap", type=float, default=2.0,
                        help="reconstruction-only cap (nats) on the "
                             "predicted per-bin log-magnitude GAIN over "
                             "the mixture (serving and evaluation only; "
                             "the training loss never sees it)")
    parser.add_argument("--Fs", type=int, default=16000)
    parser.add_argument("--context_frames", type=int, default=200)
    parser.add_argument("--window_frames", type=int, default=35)
    parser.add_argument("--random_slices", type=int, default=50)
    parser.add_argument("--augment_noise", action="store_true",
                        default=False,
                        help="random circular-shift/reversal/polarity of "
                             "train noise recordings (on-device)")
    parser.add_argument("--slices_per_step", type=int, default=4,
                        help="crops per utterance per device step "
                             "(train_mb/slices_per_step utterances a "
                             "step)")
    parser.add_argument("--decode_cache_mb", type=int, default=512,
                        help="in-memory decoded-file cache budget for "
                             "the train loader (0 disables)")
    parser.add_argument("--device_corpus", default="auto",
                        choices=("auto", "on", "off"),
                        help="keep the whole training corpus in device "
                             "memory and transfer only per-step indices "
                             "(auto: when it fits --device_corpus_mb)")
    parser.add_argument("--device_corpus_mb", type=int, default=512)
    parser.add_argument("--eval_seeds", default="valid")
    parser.add_argument("--eval_pairing", default="wrap",
                        choices=("wrap", "queue"),
                        help="eval clean<->noise pairing: 'wrap' (cycle "
                             "noises, every utterance scored) or 'queue' "
                             "(the reference's 1-epoch queue order)")
    parser.add_argument("--wav_dump_folder", default="./wav_dump/")
    parser.add_argument("--speech_wav_dir", default="./speech_wav_dir/")
    parser.add_argument("--noise_wav_dir", default="./noise_wav_dir/")
    parser.add_argument("--eval_before_training",
                        action=argparse.BooleanOptionalAction, default=False)
    parser.add_argument("--eval_after_training",
                        action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--checkpoints_to_keep", type=int, default=1000000)
    parser.add_argument("--restore_path", default="",
                        help="a checkpoint step directory of this package "
                             "(full train state) or a flat .npz of "
                             "params/batch_stats (fine-tune: fresh "
                             "optimizer, step 0)")
    parser.add_argument("--model_name", default="nhans")
    parser.add_argument("--checkpoint_dir", default="./checkpoints")
    parser.add_argument("--summaries_dir", default="./summaries")
    parser.add_argument("--dump_results", default="./dump")
    parser.add_argument("--eval_every", type=int, default=5000)
    parser.add_argument("--train_monitor_every", type=int, default=1000)
    parser.add_argument("--batches", type=int, default=3000000)
    parser.add_argument("--alg", default="sgd")
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--lr_schedule", default="constant",
                        choices=("constant", "cosine"))
    parser.add_argument("--lr_decay_steps", type=int, default=0,
                        help="cosine decay horizon in steps "
                             "(0 disables; lr decays to "
                             "lr*lr_min_frac)")
    parser.add_argument("--lr_min_frac", type=float, default=0.1)
    parser.add_argument("--snr_augment", action="store_true",
                        default=False,
                        help="extend TRAIN mixing SNRs with "
                             "{12,18,30} dB (near-clean inputs; "
                             "eval keeps the reference SNR set)")
    parser.add_argument("--clean_loss_boost", type=float, default=0.0,
                        help="upweight near-clean training windows "
                             "in the loss by 1+boost (0 disables)")
    parser.add_argument("--ctx_embed_noise", type=float, default=0.0,
                        help="train-time Gaussian jitter on the two "
                             "context embeddings, relative to their "
                             "RMS (0 disables)")
    parser.add_argument("--freq_pad_to", type=int, default=0,
                        help="carry the main tower's frequency axis "
                             "on this many columns (0 = native 201)")
    parser.add_argument("--mom", type=float, default=0.0)
    parser.add_argument("--w_std", type=float, default=0.01)
    parser.add_argument("--b_init", type=float, default=0.0)
    parser.add_argument("--bn_decay", type=float, default=0.95)
    parser.add_argument("--train_mb", type=int, default=64)
    parser.add_argument("--eval_mb", type=int, default=100)
    # fmt: on


def config_from_args(args, task: str = "denoiser") -> Config:
    """A Config from parsed reference-style command-line arguments."""
    task_cfg = (TaskConfig.denoiser() if task == "denoiser"
                else TaskConfig.separator())
    audio = AudioConfig(
        sample_rate=getattr(args, "Fs", 16000),
        recon_residual_cap=getattr(args, "recon_residual_cap", 2.0))
    model = ModelConfig(
        window_frames=getattr(args, "window_frames", 35),
        context_frames=getattr(args, "context_frames", 200),
        num_features=audio.num_features,
        w_std=getattr(args, "w_std", 0.01),
        b_init=getattr(args, "b_init", 0.0),
        bn_decay=getattr(args, "bn_decay", 0.95),
        ctx_embed_noise=getattr(args, "ctx_embed_noise", 0.0),
        freq_pad_to=getattr(args, "freq_pad_to", 0),
        compute_dtype=getattr(args, "dtype", "float32"),
        remat=getattr(args, "remat", False),
    )
    data = DataConfig(
        speech_wav_dir=getattr(args, "speech_wav_dir", "./speech_wav_dir/"),
        noise_wav_dir=getattr(args, "noise_wav_dir", "./noise_wav_dir/"),
        eval_seeds=getattr(args, "eval_seeds", "valid"),
        eval_pairing=getattr(args, "eval_pairing", "wrap"),
        random_slices=getattr(args, "random_slices", 50),
        slices_per_step=getattr(args, "slices_per_step", 4),
        augment_noise=getattr(args, "augment_noise", False),
        decode_cache_mb=getattr(args, "decode_cache_mb", 512),
        device_corpus=getattr(args, "device_corpus", "auto"),
        device_corpus_mb=getattr(args, "device_corpus_mb", 512),
        snr_augment=getattr(args, "snr_augment", False),
    )
    train = TrainConfig(
        alg=getattr(args, "alg", "sgd"),
        lr=getattr(args, "lr", 0.001),
        lr_schedule=getattr(args, "lr_schedule", "constant"),
        lr_decay_steps=getattr(args, "lr_decay_steps", 0),
        lr_min_frac=getattr(args, "lr_min_frac", 0.1),
        clean_loss_boost=getattr(args, "clean_loss_boost", 0.0),
        mom=getattr(args, "mom", 0.0),
        train_mb=getattr(args, "train_mb", 64),
        eval_mb=getattr(args, "eval_mb", 100),
        batches=getattr(args, "batches", 3_000_000),
        eval_every=getattr(args, "eval_every", 5000),
        train_monitor_every=getattr(args, "train_monitor_every", 1000),
        checkpoints_to_keep=getattr(args, "checkpoints_to_keep", 1_000_000),
        restore_path=getattr(args, "restore_path", ""),
        model_name=getattr(args, "model_name", "nhans"),
        checkpoint_dir=getattr(args, "checkpoint_dir", "./checkpoints"),
        summaries_dir=getattr(args, "summaries_dir", "./summaries"),
        dump_results=getattr(args, "dump_results", "./dump"),
        wav_dump_folder=getattr(args, "wav_dump_folder", "./wav_dump/"),
        eval_before_training=getattr(args, "eval_before_training", False),
        eval_after_training=getattr(args, "eval_after_training", True),
        profile_dir=getattr(args, "profile_dir", ""),
        data_axis=getattr(args, "data_axis", 0),
        model_axis=getattr(args, "model_axis", 1),
    )
    return Config(audio=audio, model=model, task=task_cfg, data=data,
                  train=train)
