"""f0 (pitch) by normalized autocorrelation, batched in torch (cuFFT on
the card).

Port of ``dicttts_tpu/ops/f0.py``. Per frame of ``frame_len`` samples
(centered, zero-padded, one per hop): subtract the mean, apply a Hann
window (``np.hanning``), take the ACF through an FFT of 2 * frame_len and
normalize it by its lag-0 value, divide out the window's own ACF (Praat's
normalized-AC method), pick the peak in the lag band [int(sr / f0_max),
min(int(sr / f0_min), frame_len - 2)] with a parabolic step clipped to
+-1, and call the frame voiced when the peak exceeds the threshold, the
f0 lies in [f0_min, f0_max] and the frame's rms exceeds 1e-4. Unvoiced
frames give 0. The output has one value per mel frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=4)
def _window_and_acf(frame_len: int) -> tuple[np.ndarray, np.ndarray]:
    """The Hann window and its own ACF, normalized by lag 0 (f32, numpy FFT
    in f64, then rounded)."""
    window = np.hanning(frame_len).astype(np.float32)
    nfft = 2 * frame_len
    wacf = np.fft.irfft(np.abs(np.fft.rfft(window, n=nfft)) ** 2, n=nfft)[:frame_len]
    wacf = wacf / max(wacf[0], 1e-8)
    return window, wacf.astype(np.float32)


def _frame(wav: torch.Tensor, frame_len: int, hop: int, n_frames: int) -> torch.Tensor:
    pad = frame_len // 2
    wav = F.pad(wav, (pad, pad + frame_len))
    return wav.unfold(-1, frame_len, hop)[..., :n_frames, :]


def autocorr_f0(
    wav: torch.Tensor,
    sample_rate: int = 22050,
    hop: int = 256,
    frame_len: int = 2048,
    f0_min: float = 80.0,
    f0_max: float = 750.0,
    voicing_threshold: float = 0.45,
    n_frames: int | None = None,
) -> torch.Tensor:
    """wav [..., T] (f32) -> f0 [..., n_frames] (0 where unvoiced)."""
    return autocorr_f0_frames(wav, sample_rate, hop, frame_len, f0_min, f0_max, voicing_threshold, n_frames)[0]


def autocorr_f0_frames(wav, sample_rate=22050, hop=256, frame_len=2048, f0_min=80.0, f0_max=750.0,
                       voicing_threshold=0.45, n_frames=None):
    """``autocorr_f0`` with what each frame's pick rests on: (f0, the
    integer peak lag, the spread of the normalized ACF over the lag band,
    its peak less its least value). Where the spread is at rounding level
    the band holds no peak, and the pick and its step are rounding noise."""
    if n_frames is None:
        n_frames = wav.shape[-1] // hop + 1
    frames = _frame(wav.float(), frame_len, hop, n_frames)  # [..., F, L]
    window, wacf = (torch.as_tensor(a, device=wav.device) for a in _window_and_acf(frame_len))
    frames = (frames - frames.mean(-1, keepdim=True)) * window
    nfft = 2 * frame_len
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    acf = torch.fft.irfft(spec * spec.conj(), n=nfft, dim=-1)[..., :frame_len]
    acf = acf / torch.clamp(acf[..., :1], min=1e-8)
    acf = acf / torch.clamp(wacf, min=1e-3)

    lag_min = int(sample_rate / f0_max)
    lag_max = min(int(sample_rate / f0_min), frame_len - 2)
    band = acf[..., lag_min:lag_max + 1]
    peak = band.argmax(-1) + lag_min

    def at(lag):
        return torch.gather(acf, -1, lag[..., None])[..., 0]

    peak_val = at(peak)
    y0 = at(torch.clamp(peak - 1, min=0))
    y2 = at(torch.clamp(peak + 1, max=frame_len - 1))
    denom = y0 - 2 * peak_val + y2
    ok = denom.abs() > 1e-8
    delta = torch.where(ok, 0.5 * (y0 - y2) / torch.where(ok, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
    lag = peak.float() + torch.clamp(delta, -1.0, 1.0)
    f0 = sample_rate / torch.clamp(lag, min=1.0)
    voiced = (peak_val > voicing_threshold) & (f0 >= f0_min) & (f0 <= f0_max)
    energy = torch.sqrt(torch.mean(torch.square(frames), dim=-1))
    voiced = voiced & (energy > 1e-4)
    return torch.where(voiced, f0, torch.zeros_like(f0)), peak, peak_val - band.amin(-1)


def batched_f0(wav, sample_rate=22050, hop=256, frame_len=2048, n_frames=None):
    """The binarizer's f0 of a [B, T] batch in one pass (the JAX package's
    jitted ``batched_f0``)."""
    return autocorr_f0(wav, sample_rate=sample_rate, hop=hop, frame_len=frame_len, n_frames=n_frames)
