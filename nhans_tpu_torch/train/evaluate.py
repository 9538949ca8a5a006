"""Deterministic evaluation with waveform reconstructions, the port of
``nhans_tpu/train/evaluate.py``.

* Evaluation SNRs come from the md5 of the clean path
  (``data/loader.py::EvalLoader``).
* The contexts are the first ``context_frames`` frames of the two
  conditioning signals.
* The model sees a window at every frame (stride 1) past the context
  region; each utterance is processed whole.
* Reconstruction: exp(log-magnitude) with the mixture's phase, masked to
  the utterance's frames, then the iSTFT.
* Wav dumps are named ``{model}_{step}_{clean}_{noiseA}_{noiseB}_{snrA}_
  {snrB}_{kind}.wav``.

Utterances run ``eval_batch`` at a time, zero-padded to their length
bucket; mixing, the four spectrograms (the CUDA kernel on the card),
the windows, the loss and the reconstructions stay on the device, and
the scores are computed on the host.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from nhans_tpu_torch.config import Config
from nhans_tpu_torch.dsp import mixing as mx
from nhans_tpu_torch.dsp import spectral as sp
from nhans_tpu_torch.infer.enhance import window_residuals
from nhans_tpu_torch.nn.model import NHANSNet, freq_loss_weights
from nhans_tpu_torch.utils import wavio
from nhans_tpu_torch.utils.device import full_float32, to_device
from nhans_tpu_torch.utils.scoring import estoi, pesq_score, si_sdr, stoi


class Evaluator:
    """Batched deterministic evaluator.

    ``model``: the ``NHANSNet`` to evaluate, on the device to evaluate
    on, in inference mode (BatchNorm on its population statistics); the
    evaluator never changes its mode, and ``run`` may load weights into
    it.  Utterances are grouped ``eval_batch`` at a time on the smallest
    of ``buckets_seconds`` that holds the group's longest one, and the
    windows go through the main tower ``window_chunk`` at a time with the
    contexts encoded once.  Nothing is compiled per (bucket, batch), so
    there is no program cache to guard.
    """

    def __init__(self, cfg: Config, model: NHANSNet,
                 window_chunk: int = 1024, eval_batch: int = 8,
                 buckets_seconds=(4, 8, 16, 32, 64, 128)):
        if model.training:
            raise ValueError("the evaluator needs a model in inference "
                             "mode (model.eval()); evaluate a copy of a "
                             "model in training")
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.WC = int(window_chunk)
        self.eval_batch = int(eval_batch)
        self.buckets = [int(s * cfg.audio.sample_rate)
                        for s in buckets_seconds]
        self._weights = freq_loss_weights(cfg.model.num_features,
                                          device=self.device)

    def _bucket_for(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), None) or n

    @torch.inference_mode()
    def _forward(self, buf: np.ndarray, lens: np.ndarray, snrs: np.ndarray,
                 peaks: np.ndarray):
        """One group on the device.  buf [3, B, L] raw clean/noise_a/
        noise_b, lens [3, B], snrs [2, B], peaks [B, 3] whole-file maxima.
        Returns, on the host: the per-window loss [B, nw], the valid
        windows [B, nw], the reconstructions {kind: [B, T]} and the
        output lengths [B]."""
        a, m, task = self.cfg.audio, self.cfg.model, self.cfg.task
        fl, fs, eps = a.frame_length, a.frame_step, a.log_eps
        C = m.context_frames

        def dev(x):
            return to_device(torch.from_numpy(np.ascontiguousarray(x)),
                             self.device)

        with full_float32():
            clean, na, nb = dev(buf[0]), dev(buf[1]), dev(buf[2])
            n_clean, n_a, n_b = (dev(lens[j].astype(np.int64))
                                 for j in range(3))
            snr_a, snr_b, pk = dev(snrs[0]), dev(snrs[1]), dev(peaks)
            # deterministic mixing; the SNRs were chosen on the host
            n_clean = n_clean - torch.remainder(
                torch.clamp(n_clean - fl, min=0), fs)
            clean = mx.peak_normalize(clean, n_clean, pk[:, 0])
            na_n = mx.peak_normalize(na, n_a, pk[:, 1])
            if task.two_noise_mixing:
                nb_n = mx.peak_normalize(nb, n_b, pk[:, 2])
                mixed, target, ctx_a_sig, ctx_b_sig = mx.mix_two_noise(
                    clean, na_n, nb_n, n_clean, n_a, n_b, snr_a, snr_b)
            else:
                target, _, mixed, k = mx.mix_one_noise(
                    clean, na_n, n_clean, n_a, snr_a)
                # the interference context is the FULL-length noise * K;
                # the target speaker's context is the target itself
                ctx_a_sig, ctx_b_sig = k[:, None] * na_n, target

            lm_mixed, re_m, im_m = sp.spectrogram_reim(mixed, fl, fs, eps)
            lm_target, re_t, im_t = sp.spectrogram_reim(target, fl, fs, eps)
            lm_a, re_a, im_a = sp.spectrogram_reim(ctx_a_sig, fl, fs, eps)
            lm_b, re_b, im_b = sp.spectrogram_reim(ctx_b_sig, fl, fs, eps)
            nf = 1 + torch.clamp(n_clean - fl, min=0) // fs         # [B]

            emb_a, emb_b = self.model(None, lm_a[:, :C], lm_b[:, :C])
            # a window at every frame past the context region, over the
            # whole bucket; frames past the utterance are masked below
            rest = lm_mixed[:, C:]                           # [B, nw, bins]
            res = window_residuals(self.model, rest, emb_a, emb_b, self.WC)
            denoised_lm = rest + res
            # the amplification cap bounds the reconstruction only; the
            # loss takes the raw model output
            cap = a.recon_residual_cap
            rec_lm = (rest + torch.clamp(res, max=cap) if cap > 0
                      else denoised_lm)

            nwin = rest.shape[1]
            valid = (torch.arange(nwin, device=self.device)[None, :]
                     < (nf - C)[:, None])                    # [B, nw]
            se = torch.square(denoised_lm - lm_target[:, C:])
            ex_loss = torch.mean(se * self._weights, dim=-1)  # [B, nw]

            mask = valid[..., None].to(rest.dtype)

            def recon(lm, phase):
                mag = torch.exp(lm) * mask
                return sp.istft(mag * phase[0], mag * phase[1], fl, fs)

            def phase(re, im):
                return sp.unit_phase(re[:, C:], im[:, C:])

            ph_mixed = phase(re_m, im_m)
            wavs = {"mixed": recon(rest, ph_mixed),
                    "denoised": recon(rec_lm, ph_mixed),
                    "target": recon(lm_target[:, C:], phase(re_t, im_t))}
            if task.two_noise_mixing:
                wavs["posNoise"] = recon(lm_a[:, C:], phase(re_a, im_a))
                wavs["negNoise"] = recon(lm_b[:, C:], phase(re_b, im_b))
            n_out = fs * (torch.clamp(nf - C, min=1) - 1) + fl      # [B]
        return (ex_loss.cpu().numpy(), valid.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in wavs.items()},
                n_out.cpu().numpy())

    def run(self, variables, loader, step: int = 0, modelname: str = "nhans",
            wav_dump_folder: Optional[str] = None,
            dump_results: Optional[str] = None,
            max_utts: Optional[int] = None,
            return_metrics: bool = False):
        """Evaluate the examples of ``loader`` (an ``EvalLoader`` or any
        iterable of its example dicts); returns the mean loss, or with
        ``return_metrics`` the metrics dict: ``eval_loss``, SI-SDR of the
        output and of the mixture against the target and their gain,
        STOI/ESTOI (where an utterance is long enough), PESQ, and for the
        separator SI-SDR against the interferer and the number of
        utterances closer to it than to the target.

        ``variables``: a ``state_dict`` to load into the model first, or
        None to evaluate the model's weights as they stand.  Optionally
        dumps the reconstructions as wavs and the per-window losses and
        waveforms as ``.npy`` files."""
        if variables is not None:
            self.model.load_state_dict(variables, strict=True)
        losses, counts = [], []
        sisdr_out, sisdr_in, sisdr_conf = [], [], []
        stoi_out, stoi_in, pesq_out = [], [], []
        estoi_out, estoi_in = [], []
        fs = self.cfg.audio.sample_rate

        def groups():
            """Lists of at most eval_batch examples."""
            group = []
            for i, ex in enumerate(loader):
                if max_utts is not None and i >= max_utts:
                    break
                group.append(ex)
                if len(group) == self.eval_batch:
                    yield group
                    group = []
            if group:
                yield group

        utt_index = 0
        for group in groups():
            nreal = len(group)
            longest = max(max(ex["clean_len"] for ex in group), fs)
            # a ragged last group is padded by repeating its last example
            ge = group + [group[-1]] * (self.eval_batch - nreal)
            B = len(ge)
            L = self._bucket_for(longest)
            buf = np.zeros((3, B, L), np.float32)
            lens = np.zeros((3, B), np.int32)
            snrs = np.zeros((2, B), np.float32)
            peaks = np.zeros((B, 3), np.float32)
            for r, ex in enumerate(ge):
                for j, k in enumerate(("clean", "noise_a", "noise_b")):
                    x = ex[k][:L]
                    buf[j, r, :len(x)] = x
                lens[0, r] = min(ex["clean_len"], L)
                lens[1, r] = min(ex["len_a"], L)
                lens[2, r] = min(ex["len_b"], L)
                snrs[0, r], snrs[1, r] = ex["snr_a"], ex["snr_b"]
                peaks[r] = np.asarray(
                    ex.get("peaks",
                           [np.abs(buf[j, r]).max() for j in range(3)]),
                    np.float32)
            ex_loss, valid, host_wavs, n_out = self._forward(buf, lens, snrs,
                                                             peaks)
            for r in range(nreal):
                ex = group[r]
                losses.append(float((ex_loss[r] * valid[r]).sum()))
                counts.append(int(valid[r].sum()))
                n = int(n_out[r])
                utt_wavs = {k: w[r, :n] for k, w in host_wavs.items()}
                den, mix, tgt = (utt_wavs[k]
                                 for k in ("denoised", "mixed", "target"))
                sisdr_out.append(si_sdr(den, tgt))
                sisdr_in.append(si_sdr(mix, tgt))
                if not self.cfg.task.two_noise_mixing:
                    # separator confusion: the output against the
                    # interferer (mixed - target); closer to it than to
                    # the target flags the wrong speaker extracted
                    sisdr_conf.append(si_sdr(den, mix - tgt))
                s = stoi(den, tgt, fs)
                if np.isfinite(s):
                    stoi_out.append(s)
                    stoi_in.append(stoi(mix, tgt, fs))
                    estoi_out.append(estoi(den, tgt, fs))
                    estoi_in.append(estoi(mix, tgt, fs))
                p = pesq_score(den, tgt, fs)
                if p is not None:
                    pesq_out.append(p)
                if wav_dump_folder:
                    self._dump_wavs(wav_dump_folder, modelname, step, ex,
                                    utt_wavs)
                if dump_results:
                    os.makedirs(dump_results, exist_ok=True)
                    prefix = os.path.join(dump_results,
                                          f"{modelname}_eval_{step}")
                    np.save(f"{prefix}_loss_{utt_index}",
                            ex_loss[r][valid[r].astype(bool)])
                    for kind, w in utt_wavs.items():
                        np.save(f"{prefix}_{kind}_{utt_index}", w)
                utt_index += 1
        mean_loss = sum(losses) / max(sum(counts), 1)
        print(f"loss: {mean_loss}")
        metrics = {
            "eval_loss": mean_loss,
            "si_sdr": float(np.mean(sisdr_out)) if sisdr_out else 0.0,
            "si_sdr_mixed": float(np.mean(sisdr_in)) if sisdr_in else 0.0,
        }
        metrics["si_sdr_gain"] = metrics["si_sdr"] - metrics["si_sdr_mixed"]
        if sisdr_conf:
            metrics["si_sdr_interferer"] = float(np.mean(sisdr_conf))
            metrics["confused_utts"] = int(sum(
                c > o for c, o in zip(sisdr_conf, sisdr_out)))
        print(f"si_sdr: {metrics['si_sdr']:.2f} dB "
              f"(mixed: {metrics['si_sdr_mixed']:.2f} dB, "
              f"gain: {metrics['si_sdr_gain']:+.2f} dB)")
        if stoi_out:
            metrics["stoi"] = float(np.mean(stoi_out))
            metrics["stoi_mixed"] = float(np.mean(stoi_in))
            print(f"stoi: {metrics['stoi']:.3f} "
                  f"(mixed: {metrics['stoi_mixed']:.3f})")
            metrics["estoi"] = float(np.mean(estoi_out))
            metrics["estoi_mixed"] = float(np.mean(estoi_in))
            print(f"estoi: {metrics['estoi']:.3f} "
                  f"(mixed: {metrics['estoi_mixed']:.3f})")
        if pesq_out:
            metrics["pesq"] = float(np.mean(pesq_out))
            print(f"pesq: {metrics['pesq']:.2f}")
        return metrics if return_metrics else mean_loss

    def _dump_wavs(self, folder: str, modelname: str, step: int, ex: dict,
                   wavs: Dict[str, np.ndarray]) -> None:
        def stem(path):
            return os.path.splitext(os.path.basename(path))[0]

        b = stem(ex["path_b"]) if ex["path_b"] else "none"
        for kind, w in wavs.items():
            fname = (f"{modelname}_{step}_{stem(ex['cleanpath'])}_"
                     f"{stem(ex['path_a'])}_{b}_{ex['snr_a']}_"
                     f"{ex['snr_b']}_{kind}.wav")
            wavio.write_wav(os.path.join(folder, fname), w,
                            self.cfg.audio.sample_rate)
