"""Speaker embeddings for multi-speaker corpora, on the host.

Port of ``dicttts_tpu/ops/speaker.py``:
- ``spectral_speaker_stats``: a deterministic 256-d acoustic-statistics
  embedding (mel mean and std, delta statistics, f0 statistics), the
  stand-in without a speaker-encoder checkpoint;
- ``resemblyzer_mel``: Resemblyzer's front end (16 kHz by scipy's
  ``resample_poly``, -30 dBFS volume, 25 ms / 10 ms power mel with 40
  bins, no log; no VAD trimming);
- ``speaker_embed``: with ``cfg['spk_encoder_ckpt']`` the GE2E encoder
  (``models/speaker_encoder.py``) on Resemblyzer's mel of the wav (the
  corpus mel cut or padded to the encoder's bins without a wav), on
  ``device``; else the spectral statistics.
"""

from __future__ import annotations

import numpy as np

from dicttts_tpu_torch.ops.mel import hann_window, mel_filterbank


def spectral_speaker_stats(mel: np.ndarray, f0: np.ndarray | None = None, dim: int = 256) -> np.ndarray:
    """mel [T, M] (+ optional f0 [T]) -> l2-normalized [dim] embedding."""
    mel = np.asarray(mel, np.float32)
    feats = [mel.mean(0), mel.std(0)]
    d = np.diff(mel, axis=0) if len(mel) > 1 else np.zeros_like(mel)
    feats += [d.mean(0), d.std(0)]
    if f0 is not None:
        v = f0[f0 > 0]
        feats.append(np.asarray([v.mean() if v.size else 0.0, v.std() if v.size else 0.0,
                                 (f0 > 0).mean()], np.float32))
    x = np.concatenate(feats)
    if len(x) < dim:
        x = np.pad(x, (0, dim - len(x)))
    x = x[:dim]
    n = np.linalg.norm(x)
    return (x / n if n > 0 else x).astype(np.float32)


def resemblyzer_mel(wav: np.ndarray, sr: int) -> np.ndarray:
    """wav at ``sr`` -> [T, 40] power mel of Resemblyzer's front end."""
    wav = np.asarray(wav, np.float32)
    if sr != 16000:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(16000, int(sr))
        wav = resample_poly(wav, 16000 // g, int(sr) // g).astype(np.float32)
    rms = float(np.sqrt(np.mean(wav ** 2) + 1e-12))
    wav = wav * (10 ** (-30 / 20) / max(rms, 1e-12))
    n_fft, hop, n_mels = 400, 160, 40
    w = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    window = np.asarray(hann_window(n_fft, periodic=True), np.float32)
    n_frames = 1 + (len(w) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    spec = np.abs(np.fft.rfft(w[idx] * window, n=n_fft, axis=-1)) ** 2
    basis = mel_filterbank(16000, n_fft, n_mels, 0.0, 8000.0)
    return (spec @ basis.T).astype(np.float32)


_GE2E_CACHE: dict = {}


def speaker_embed(mel: np.ndarray, f0: np.ndarray | None, cfg: dict, wav: np.ndarray | None = None,
                  sr: int | None = None, device="cuda") -> np.ndarray:
    """One utterance's speaker embedding (the GE2E encoder with
    ``spk_encoder_ckpt``, else ``spectral_speaker_stats``). A checkpoint
    that is not a Resemblyzer ``state_dict`` raises."""
    ckpt = cfg.get("spk_encoder_ckpt")
    if not ckpt:
        return spectral_speaker_stats(mel, f0)
    from dicttts_tpu_torch.models.speaker_encoder import embed_utterance, load_resemblyzer

    key = (ckpt, str(device))
    if key not in _GE2E_CACHE:
        try:
            _GE2E_CACHE[key] = load_resemblyzer(ckpt, device)
        except KeyError as e:
            raise ValueError(f"spk_encoder_ckpt {ckpt!r} is not a Resemblyzer VoiceEncoder "
                             f"state_dict (missing {e})") from e
    model = _GE2E_CACHE[key]
    mel_n = model.lstm.input_size
    if wav is not None and mel_n == 40:
        m = resemblyzer_mel(wav, int(sr or 22050))
    else:
        m = mel[:, :mel_n] if mel.shape[1] >= mel_n else np.pad(mel, ((0, 0), (0, mel_n - mel.shape[1])))
    return embed_utterance(model, np.asarray(m, np.float32))
