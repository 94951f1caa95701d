"""Spectral-subtraction denoise (the pre-align stage's ``denoise`` option).

Port of ``dicttts_tpu/vocoders/denoise.py`` (numpy, copied): estimate the
noise magnitude from the quietest tenth of the frames and subtract ``v``
times it in the magnitude domain, then overlap-add.
"""

from __future__ import annotations

import numpy as np

from dicttts_tpu_torch.ops.mel import hann_window


def denoise(wav: np.ndarray, v: float = 0.1, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    wav = np.asarray(wav, np.float32)
    window = hann_window(n_fft)
    pad = n_fft // 2
    x = np.pad(wav, (pad, pad))
    n_frames = 1 + (len(x) - n_fft) // hop
    frames = np.stack([x[i * hop : i * hop + n_fft] for i in range(n_frames)]) * window
    spec = np.fft.rfft(frames, axis=-1)
    mag, phase = np.abs(spec), np.angle(spec)
    energy = mag.sum(-1)
    k = max(1, int(0.1 * len(energy)))
    noise_profile = mag[np.argsort(energy)[:k]].mean(0, keepdims=True)
    mag = np.maximum(mag - v * noise_profile, 0.0)
    spec = mag * np.exp(1j * phase)
    frames_out = np.fft.irfft(spec, n=n_fft, axis=-1) * window
    # overlap-add
    out = np.zeros(len(x))
    norm = np.zeros(len(x))
    for i in range(n_frames):
        out[i * hop : i * hop + n_fft] += frames_out[i]
        norm[i * hop : i * hop + n_fft] += window**2
    out = out / np.maximum(norm, 1e-8)
    return out[pad : pad + len(wav)].astype(np.float32)
