"""Whole-utterance enhancement: the port of ``nhans_tpu/infer/enhance.py``.

Peak-normalised waveform -> log-magnitude and raw re/im of the mixture
(the CUDA spectrogram kernel on the card) -> the 35-frame window of every
frame that reaches the output through the conditional ResNet, with both
200-frame contexts encoded once -> residual added to the central frame,
amplification cap -> masked iSTFT that reuses the mixed phase -> SNR
estimate.

Utterances run on the utterance zero-padded to its length bucket and on
a batch padded to a power of two, exactly as in the JAX package, so that
the windows of the last frames read the same zero-audio frames and the
outputs agree.  The tower, though, computes only the windows of each
real row's own frames in its kept range (:func:`kept_windows`): the
frames past a file's end, the pad rows and ``enhance_long``'s halos are
masked out of the reconstruction, and in eval mode a window's residual
depends on that window alone, so skipping them changes no output.  The
JAX package's device-tunnel machinery (packed parameters, the int16
output wire) is not carried over: outputs are float32, as with the JAX
``Enhancer(out_wire="float32")``.

Each batch records spans and counts (``utils/spans.py``) under its
sequence number while the profiler runs or ``spans.recording()`` is on:
``enhance.dispatch`` (host preparation, count ``real_windows``),
``enhance.launch`` around ``enhance.contexts`` and ``enhance.run``
(counts ``windows``, computed, and ``skipped_windows``: the rest of the
rows x bucket frames), then ``enhance.materialize``.  The counts are
taken only while a span records.

Several devices (``devices``, the JAX package's ``Enhancer(mesh=...)``):
one process keeps a replica of the weights on each and splits the rows
of every batch over them, a contiguous block each; utterances are
independent, so nothing is exchanged.  Every device's work is queued
before any result is read back, so the devices run together.
"""

from __future__ import annotations

import collections
import copy
import hashlib
import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.dsp import spectral as sp
from nhans_tpu_torch.dsp.windowing import pad_amounts, pad_for_windowing
from nhans_tpu_torch.nn.model import NHANSNet
from nhans_tpu_torch.utils import spans
from nhans_tpu_torch.utils.device import full_float32, resolve_device


def context_samples(cfg: Config) -> int:
    """Samples covering exactly ``context_frames`` frames: a context
    recording contributes only its first 200 frames."""
    a = cfg.audio
    return (cfg.model.context_frames - 1) * a.frame_step + a.frame_length


# Length buckets of the JAX package: quarter-second steps from 1 to 4 s,
# about 1.2x geometric above.
DEFAULT_BUCKETS_SECONDS = (1, 1.25, 1.5, 1.75, 2, 2.25, 2.5, 2.75, 3,
                           3.25, 3.5, 3.75, 4, 5, 6, 7, 8, 10, 12,
                           16, 20, 24, 32, 40, 48, 64, 80, 96, 128)


def window_residuals(model: NHANSNet, logmag: torch.Tensor,
                     emb_a: torch.Tensor, emb_b: torch.Tensor,
                     window_chunk: int, keep=None) -> torch.Tensor:
    """Model residuals [B, F, bins] for the frames' windows of ``logmag``
    [B, F, bins], the windows gathered ``window_chunk`` at a time from the
    zero-padded log-magnitude (17 frames before, 17 after) rather than
    materialised at once.  ``emb_a``/``emb_b`` [B, 512] are the rows'
    context embeddings.

    ``keep``: None computes every frame's window; else an int64 tensor of
    flat window indices ``b * F + f`` on the logmag's device, the only
    windows computed, every other residual left 0.  In eval mode a
    window's residual depends on that window alone, so the kept ones equal
    the full computation's."""
    W = model.cfg.window_frames
    B, nframes, nfeat = logmag.shape
    dev = logmag.device
    padded = pad_for_windowing(logmag, W)
    flat_spec = padded.reshape(-1, nfeat)
    fp = nframes + W - 1
    karange = torch.arange(W, device=dev)
    nwin = B * nframes
    count = nwin if keep is None else keep.shape[0]
    out = (torch.empty if keep is None else torch.zeros)(
        (nwin, nfeat), dtype=logmag.dtype, device=dev)
    for start in range(0, count, window_chunk):
        stop = min(start + window_chunk, count)
        widx = (torch.arange(start, stop, device=dev) if keep is None
                else keep[start:stop])
        b = widx // nframes
        rows = b * fp + widx % nframes
        wchunk = flat_spec[rows[:, None] + karange[None, :]]
        out.index_copy_(0, widx, model(wchunk, emb_a=emb_a[b],
                                       emb_b=emb_b[b]))
    return out.reshape(B, nframes, nfeat)


def kept_windows(ints: np.ndarray, nframes: int, frame_length: int,
                 frame_step: int) -> np.ndarray:
    """The flat indices ``b * nframes + f`` of the windows that reach the
    reconstruction, on the host: frames in [keep_from, min(nf,
    keep_until)) of each row of ints [B, 5] = (n_mixed, n_pos, n_neg,
    keep_from, keep_until), nf the row's own frames."""
    ints = ints.astype(np.int64)
    nf = 1 + np.maximum(ints[:, 0] - frame_length, 0) // frame_step
    f = np.arange(nframes)[None, :]
    return np.flatnonzero((f >= ints[:, 3:4])
                          & (f < np.minimum(nf, ints[:, 4])[:, None]))


class Enhancer:
    """Enhancement engine for a task (denoiser or separator).

    ``state_dict``: the model's weights (``compat.weights.load_npz``).
    ``window_chunk``: windows per model call, which bounds activation
    memory.  ``device``: ``cuda`` unless the caller asks for ``cpu``.
    ``devices``: several devices to split each batch's rows over, a power
    of two of them (in place of ``device``); a batch then has at least
    one row per device.
    """

    def __init__(self, cfg: Config, state_dict, window_chunk: int = 2048,
                 buckets_seconds=DEFAULT_BUCKETS_SECONDS, device="cuda",
                 devices=None):
        self.cfg = cfg
        if devices is None:
            devices = [device]
        n = len(devices)
        if n < 1 or n & (n - 1):
            raise ValueError(f"Enhancer devices: {n} given; the count must "
                             "be a power of two (batches ride power-of-two "
                             "sizes)")
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        model = NHANSNet(cfg.model)
        model.load_state_dict(state_dict, strict=True)
        self.models = [copy.deepcopy(model).to(d).eval()
                       for d in self.devices]
        self.model = self.models[0]
        self.window_chunk = int(window_chunk)
        self.buckets = [int(s * cfg.audio.sample_rate) for s in buckets_seconds]
        self._ctx_cache = collections.OrderedDict()
        self._ctx_cache_max = 8
        self._seq = itertools.count(1)  # the batches' spans' id

    # ------------------------------------------------------------------ #
    # device work
    # ------------------------------------------------------------------ #

    @staticmethod
    def _tensor(arr: np.ndarray, device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    def _bucket_for(self, num_samples: int) -> int:
        """The smallest bucket that holds the utterance; beyond the largest
        one, the utterance's own length."""
        return next((b for b in self.buckets if b >= num_samples), num_samples)

    @torch.inference_mode()
    @full_float32()
    def _encode_contexts(self, ctx: np.ndarray, ints: np.ndarray,
                         peaks: np.ndarray, shard: int = 0):
        """(emb_a, emb_b) [B, 512] on device ``shard`` for int16 context
        buffers ctx [B, 2, ctx_n], memoised on the context bytes (bounded
        LRU)."""
        B = ctx.shape[0]
        dev, model = self.devices[shard], self.models[shard]
        h = hashlib.sha1(ctx.tobytes())
        h.update(ints[:, 1:3].tobytes())
        h.update(peaks[:, 1:3].tobytes())
        key = (shard, B, h.hexdigest())
        hit = self._ctx_cache.get(key)
        if hit is not None:
            self._ctx_cache.move_to_end(key)
            return hit
        a, m = self.cfg.audio, self.cfg.model
        fl, fs = a.frame_length, a.frame_step
        ctx_t = self._tensor(ctx, dev).to(torch.float32)
        peaks_t = self._tensor(peaks, dev)
        pos = ctx_t[:, 0] / (peaks_t[:, 1:2] + 1e-6)
        neg = ctx_t[:, 1] / (peaks_t[:, 2:3] + 1e-6)
        # both contexts of every row in one spectrogram launch [2B, ctx_n]
        lm = sp.log_spectrogram(torch.cat([pos, neg]), fl, fs, a.log_eps)
        counts = self._tensor(ints[:, 1:3].astype(np.int64), dev)
        # the first 200 frames, tiled cyclically when the recording is short
        nf = torch.clamp(1 + torch.clamp(counts - fl, min=0) // fs, min=1)
        ar = torch.arange(m.context_frames, device=dev)[None, :]
        tiled = []
        for col, spec in enumerate((lm[:B], lm[B:])):
            idx = torch.remainder(ar, nf[:, col:col + 1])
            tiled.append(torch.gather(
                spec, 1, idx[:, :, None].expand(-1, -1, spec.shape[-1])))
        embs = model(None, tiled[0], tiled[1])
        self._ctx_cache[key] = embs
        while len(self._ctx_cache) > self._ctx_cache_max:
            self._ctx_cache.popitem(last=False)
        return embs

    @torch.inference_mode()
    @full_float32()
    def _run(self, mixed: np.ndarray, ints: np.ndarray, peaks: np.ndarray,
             emb_a: torch.Tensor, emb_b: torch.Tensor, keep: np.ndarray,
             shard: int = 0):
        """One batch on device ``shard``.  mixed [B, L] int16 raw samples;
        ints [B, 5] = (n_mixed, n_pos, n_neg, keep_from, keep_until);
        peaks [B, 3] whole-file peaks.  Only frames in
        [keep_from, min(keep_until, nf)) reach the reconstruction, and only
        their windows, ``keep`` (:func:`kept_windows` of ``ints``), go
        through the tower; the spectrogram, iSTFT and SNR estimate run on
        the whole bucket.  Nothing here reads the device back.
        Returns wavs [B, 2, L'] (denoised, mixed_processed) and
        meta [B, 3] (snr_est, n_out, cap_clip_frac), still on the device."""
        a, m = self.cfg.audio, self.cfg.model
        fl, fs = a.frame_length, a.frame_step
        dev = self.devices[shard]
        x = (self._tensor(mixed, dev).to(torch.float32)
             / (self._tensor(peaks, dev)[:, 0:1] + 1e-6))
        n_mixed = self._tensor(ints[:, 0].astype(np.int64), dev)
        logmag, s_re, s_im = sp.spectrogram_reim(x, fl, fs, a.log_eps)
        B, nframes = logmag.shape[:2]
        nf = 1 + torch.clamp(n_mixed - fl, min=0) // fs
        keep_t = self._tensor(keep, dev)
        fmask = (torch.zeros(B * nframes, dtype=torch.bool, device=dev)
                 .index_fill_(0, keep_t, True).view(B, nframes))  # [B, F]

        residuals = window_residuals(self.models[shard], logmag, emb_a,
                                     emb_b, self.window_chunk, keep=keep_t)
        cap = a.recon_residual_cap
        if cap > 0:
            # amplification cap: inert on healthy outputs, bounds
            # off-manifold low-bin blowups; the clipped fraction is
            # reported so that the host can say when the cap bites
            vmask = fmask[..., None]
            cap_frac = (torch.sum((residuals > cap) & vmask, dim=(1, 2))
                        .to(torch.float32)
                        / torch.clamp(torch.sum(vmask, dim=(1, 2))
                                      * m.num_features, min=1))
            residuals = torch.clamp(residuals, max=cap)
        else:
            cap_frac = torch.zeros(x.shape[0], device=dev)
        denoised_lm = logmag + residuals

        # masked reconstruction with the mixed phase: cos/sin of the phase
        # are re/|X| and im/|X|
        mask = fmask[..., None].to(logmag.dtype)
        cosp, sinp = sp.unit_phase(s_re, s_im)

        def recon(lm):
            mag = torch.exp(lm) * mask
            return sp.istft(mag * cosp, mag * sinp, fl, fs)

        denoised_wav = recon(denoised_lm)
        mixed_wav = recon(logmag)
        removed_wav = mixed_wav - denoised_wav

        n_out = fs * (nf - 1) + fl                                  # [B]
        smask = (torch.arange(denoised_wav.shape[-1], device=dev)
                 [None, :] < n_out[:, None]).to(denoised_wav.dtype)
        d2 = torch.sum(torch.square(denoised_wav) * smask, dim=-1)
        r2 = torch.sum(torch.square(removed_wav) * smask, dim=-1)
        snr_est = d2 / torch.clamp(r2, min=1e-12)
        wavs = torch.stack([denoised_wav * smask, mixed_wav * smask], dim=1)
        meta = torch.stack([snr_est, n_out.to(torch.float32), cap_frac], dim=1)
        return wavs, meta

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def prepare_wave(self, samples: np.ndarray) -> Tuple[np.ndarray, int, float]:
        """(int16 samples trimmed to whole frames, their count, the peak of
        the WHOLE file).  The peak is taken before the trim."""
        a = self.cfg.audio
        peak = float(np.max(np.abs(samples))) if len(samples) else 0.0
        n = a.trim_to_whole_frames(len(samples))
        return np.rint(samples[:n]).astype(np.int16), n, peak

    @staticmethod
    def _context_row(w: np.ndarray, ctx_n: int):
        """(int16 buffer of the first ctx_n samples, their count, the peak
        of the whole recording)."""
        buf = np.zeros(ctx_n, np.int16)
        n = min(len(w), ctx_n)
        buf[:n] = np.rint(w[:n]).astype(np.int16)
        return buf, n, (float(np.max(np.abs(w))) if len(w) else 0.0)

    def _dispatch(self, mixed_list, pos_list, neg_list):
        """Host preparation and the batch's device work, left running
        asynchronously on the card: (outs, nreal, seq), for
        :meth:`_finish`.  The power-of-two pad rows keep no frame, so the
        tower computes none of their windows (their outputs, zeros, are
        never returned).  Span ``enhance.dispatch`` around the padding and
        context rows, count ``real_windows``: the frames of the real rows
        (not of the power-of-two pad rows)."""
        a = self.cfg.audio
        seq = next(self._seq)
        with spans.span("enhance.dispatch", id=seq) as s:
            ctx_n = context_samples(self.cfg)
            nreal = len(mixed_list)
            # the next power of two, and at least a row per device
            B = max(1 << max(0, (nreal - 1).bit_length()), len(self.devices))
            pad_b = B - nreal
            mixed_list = list(mixed_list) + [mixed_list[-1]] * pad_b
            pos_list = list(pos_list) + [pos_list[-1]] * pad_b
            neg_list = list(neg_list) + [neg_list[-1]] * pad_b
            prep = [self.prepare_wave(x) for x in mixed_list]
            n_mixed = np.array([p[1] for p in prep], np.int32)
            bucket = self._bucket_for(int(n_mixed.max()))
            if s is not spans.OFF:
                s.count(real_windows=sum(a.num_frames(int(n))
                                         for n in n_mixed[:nreal]))

            peaks = np.zeros((B, 3), np.float32)
            mixed = np.zeros((B, bucket), np.int16)
            for i, (x, n, pk) in enumerate(prep):
                mixed[i, :n] = x
                peaks[i, 0] = pk
            ctx = np.zeros((B, 2, ctx_n), np.int16)
            ints = np.zeros((B, 5), np.int32)
            ints[:, 0] = n_mixed
            for col, waves in ((0, pos_list), (1, neg_list)):
                for i, w in enumerate(waves):
                    ctx[i, col], ints[i, col + 1], peaks[i, col + 1] = \
                        self._context_row(w, ctx_n)
            ints[:nreal, 4] = sp.num_frames(bucket, a.frame_length,
                                            a.frame_step)
        return self._launch(mixed, ints, peaks, ctx, seq), nreal, seq

    def _launch(self, mixed: np.ndarray, ints: np.ndarray,
                peaks: np.ndarray, ctx: np.ndarray, seq=None) -> list:
        """The batch's device work, its rows split over the devices in
        contiguous blocks: [(wavs, meta)] per device, still on the
        devices.  Nothing waits for a device here.  The tower computes
        only the windows that reach the reconstruction
        (:func:`kept_windows`, from ``ints`` on the host).  Span
        ``enhance.launch`` around each device's ``enhance.contexts`` and
        ``enhance.run``, counts ``windows``: the windows the tower
        computes, and ``skipped_windows``: the rest of its rows x
        frames."""
        a = self.cfg.audio
        per = mixed.shape[0] // len(self.devices)
        nframes = sp.num_frames(mixed.shape[1], a.frame_length, a.frame_step)
        outs = []
        with spans.span("enhance.launch", id=seq):
            for i in range(len(self.devices)):
                r = slice(i * per, (i + 1) * per)
                with spans.span("enhance.contexts", id=seq):
                    emb_a, emb_b = self._encode_contexts(ctx[r], ints[r],
                                                         peaks[r], i)
                with spans.span("enhance.run", id=seq) as s:
                    keep = kept_windows(ints[r], nframes, a.frame_length,
                                        a.frame_step)
                    if s is not spans.OFF:
                        s.count(windows=len(keep),
                                skipped_windows=per * nframes - len(keep))
                    outs.append(self._run(mixed[r], ints[r], peaks[r],
                                          emb_a, emb_b, keep, i))
        return outs

    @staticmethod
    def _gather(outs) -> Tuple[np.ndarray, np.ndarray]:
        """(wavs, meta) of ``_launch``'s blocks on the host, in row
        order."""
        return tuple(np.concatenate([o[j].cpu().numpy() for o in outs])
                     for j in (0, 1))

    @classmethod
    def _materialize(cls, outs, nreal) -> Dict[str, list]:
        wavs, meta = cls._gather(outs)
        den, mix = wavs[:, 0], wavs[:, 1]
        snr = meta[:, 0]
        n_out = meta[:, 1].astype(np.int64)
        cap_frac = meta[:, 2]
        if float(np.max(cap_frac[:nreal], initial=0.0)) > 1e-4:
            # the amplification cap bit: the output now diverges from the
            # reference toolkit's unbounded exp()
            worst = int(np.argmax(cap_frac[:nreal]))
            print("NOTE: recon_residual_cap clipped "
                  f"{100 * float(cap_frac[worst]):.2f}% of "
                  f"spectrogram bins (worst: utterance {worst} of "
                  f"{nreal} in this batch; per-utterance fractions in "
                  "the returned cap_clip_frac) "
                  "(--recon_residual_cap 0 disables the cap)",
                  flush=True)
        return {
            "denoised": [den[i, :n_out[i]] for i in range(nreal)],
            "mixed_processed": [mix[i, :n_out[i]] for i in range(nreal)],
            "removed": [mix[i, :n_out[i]] - den[i, :n_out[i]]
                        for i in range(nreal)],
            "snr_est": snr[:nreal],
            "cap_clip_frac": cap_frac[:nreal],
        }

    def _finish(self, dispatched) -> Dict[str, list]:
        """The results of a batch that :meth:`_dispatch` left running, on
        the host; span ``enhance.materialize``."""
        outs, nreal, seq = dispatched
        with spans.span("enhance.materialize", id=seq):
            return self._materialize(outs, nreal)

    def enhance_batch(self, mixed_list, pos_list, neg_list) -> Dict[str, list]:
        """Enhance a batch of raw (un-normalised, int16-scale) waveforms
        together, on one bucket sized by the longest one and a batch padded
        to a power of two."""
        return self._finish(self._dispatch(mixed_list, pos_list, neg_list))

    def enhance_long(self, mixed: np.ndarray, pos: np.ndarray,
                     neg: np.ndarray, segment_seconds: float = 32.0,
                     segment_batch: int = 8) -> Dict[str, np.ndarray]:
        """Enhance audio of any length on one segment bucket.

        A window sees +-17 frames, so each segment carries a 17-frame halo
        and only its core frames reach the reconstruction; overlap-add is
        linear, so the segments' waveforms summed at their offsets give the
        unsegmented result up to float addition order.  Edge segments get
        no halo at the utterance's ends, which keeps the zero-padded first
        and last windows.  The tower computes only the core frames'
        windows: the halos and the empty rows of the last group keep no
        frame, and only their spectrogram and iSTFT run.  Each group of
        segments records the spans of a batch (``_dispatch``); its
        ``real_windows`` are its segments' core frames, which sum to the
        utterance's frames."""
        a = self.cfg.audio
        fl, fs = a.frame_length, a.frame_step
        H = pad_amounts(self.cfg.model.window_frames)[0]  # 17
        ctx_n = context_samples(self.cfg)

        wav, n, peak = self.prepare_wave(mixed)
        F_total = sp.num_frames(n, fl, fs)
        seg_n = a.trim_to_whole_frames(int(segment_seconds * a.sample_rate))
        core = max(sp.num_frames(seg_n, fl, fs) - 2 * H, 1)
        Lseg = self._bucket_for(seg_n)

        pos_b, n_pos, pk_pos = self._context_row(pos, ctx_n)
        neg_b, n_neg, pk_neg = self._context_row(neg, ctx_n)

        cores = list(range(0, F_total, core))
        out_len = fs * (F_total - 1) + fl
        den_full = np.zeros(out_len, np.float64)
        mix_full = np.zeros(out_len, np.float64)
        # a multiple of the device count, at least one row per device
        ndev = len(self.devices)
        B = -(-max(segment_batch, ndev) // ndev) * ndev
        for i0 in range(0, len(cores), B):
            seq = next(self._seq)
            group = cores[i0:i0 + B]
            with spans.span("enhance.dispatch", id=seq) as s:
                seg = np.zeros((B, Lseg), np.int16)
                ints = np.zeros((B, 5), np.int32)  # padded rows keep nothing
                ints[:, 1], ints[:, 2] = n_pos, n_neg
                offsets = np.zeros((B,), np.int64)
                peaks = np.zeros((B, 3), np.float32)
                peaks[:, 0], peaks[:, 1], peaks[:, 2] = peak, pk_pos, pk_neg
                for j, c0 in enumerate(group):
                    c1 = min(c0 + core, F_total)
                    h_l = min(H, c0)
                    h_r = min(H, F_total - c1)
                    count = (c1 - c0) + h_l + h_r
                    s0 = (c0 - h_l) * fs
                    ns = min((count - 1) * fs + fl, n - s0)
                    seg[j, :ns] = wav[s0:s0 + ns]
                    ints[j, 0], ints[j, 3], ints[j, 4] = (ns, h_l,
                                                          h_l + (c1 - c0))
                    offsets[j] = s0
                    s.count(real_windows=c1 - c0)
                ctx = np.zeros((B, 2, ctx_n), np.int16)
                ctx[:, 0], ctx[:, 1] = pos_b, neg_b
            # contexts are the same for every segment: encoded once (cache)
            launched = self._launch(seg, ints, peaks, ctx, seq)
            with spans.span("enhance.materialize", id=seq):
                wavs, _ = self._gather(launched)
                for j in range(len(group)):
                    o = offsets[j]
                    span = min(wavs.shape[-1], out_len - o)
                    den_full[o:o + span] += wavs[j, 0, :span]
                    mix_full[o:o + span] += wavs[j, 1, :span]

        removed = mix_full - den_full
        snr_est = (np.mean(np.square(den_full))
                   / max(np.mean(np.square(removed)), 1e-12))
        return {"denoised": den_full, "mixed_processed": mix_full,
                "removed": removed, "snr_est": float(snr_est)}

    def enhance_stream(self, batches, depth: int = 2):
        """Steady-state serving: iterate over (mixed_list, pos_list,
        neg_list) batches keeping ``depth`` batches in flight on the
        device, so that host preparation overlaps device work.  Yields
        result dicts in order."""
        q = collections.deque()
        for batch in batches:
            q.append(self._dispatch(*batch))
            if len(q) >= depth:
                yield self._finish(q.popleft())
        while q:
            yield self._finish(q.popleft())

    def enhance(self, mixed: np.ndarray, pos: np.ndarray,
                neg: np.ndarray) -> Dict[str, np.ndarray]:
        out = self.enhance_batch([mixed], [pos], [neg])
        return {k: v[0] for k, v in out.items()}

    @staticmethod
    def compensate(denoised: np.ndarray, removed: np.ndarray,
                   snr_est: float, compensate: float = 0.0,
                   ac: bool = False) -> np.ndarray:
        """Energy compensation: ``denoised + removed * c`` with c from
        --compensate, or snr_est / 20 under --ac."""
        c = (snr_est / 20.0) if ac else compensate
        return denoised + removed * c
