"""STFT and log-mel spectrograms in torch (cuFFT on the card), with the
librosa formulas.

Port of ``dicttts_tpu/ops/mel.py``. The upstream binarizer extracts mels on
the host with librosa (data_gen/tts/data_gen_utils.py:93-147): a centered
STFT with a periodic Hann window and ``pad_mode="constant"``, magnitude,
a Slaney-scaled mel filterbank, then log10(max(eps, mel)). The filterbank
is computed in numpy once; the FFT and the matmul run batched on the
tensor's device; the window and the filterbank are copied to a device once
and kept (``_on_device``), so a step that uses them copies nothing from
the host and a CUDA graph can capture it. ``gan_log_mel`` is HiFi-GAN's training mel (upstream
modules/hifigan/mel_utils.py:45-80): reflect-padded, non-centered frames,
natural-log compression. No Pallas kernel is involved in the JAX package's
version either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


def _hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz(mel, htk: bool = False):
    mel = np.asarray(mel, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mel >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mel - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    htk: bool = False,
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2+1], librosa.filters.mel math."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


_DEVICE_CONSTANTS: dict = {}


def _on_device(array: np.ndarray, key: tuple, device: torch.device) -> torch.Tensor:
    """``array`` (a constant named by ``key``) as a tensor on ``device``,
    copied there once."""
    k = (key, str(device))
    if k not in _DEVICE_CONSTANTS:
        _DEVICE_CONSTANTS[k] = torch.as_tensor(array, device=device)
    return _DEVICE_CONSTANTS[k]


def frame_signal(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Slice an already-padded [..., T] signal into [..., frames, n_fft]."""
    return wav.unfold(-1, n_fft, hop)


def _pad_last(wav: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the last axis of [..., T]; ``reflect`` mirrors without repeating
    the edge sample, as numpy's does."""
    if mode != "reflect":
        return F.pad(wav, (left, right))
    lead = wav.shape[:-1]
    out = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (left, right), mode="reflect")
    return out.reshape(*lead, out.shape[-1])


def stft_magnitude(
    wav: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 256,
    win_length: int = 1024,
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """|STFT| of [..., T] -> [..., frames, n_fft//2+1]."""
    window = _on_device(hann_window(win_length, periodic=True), ("hann", win_length), wav.device)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = F.pad(window, (pad, n_fft - win_length - pad))
    if center:
        wav = _pad_last(wav, n_fft // 2, n_fft // 2, pad_mode)
    frames = frame_signal(wav, n_fft, hop) * window
    return torch.abs(torch.fft.rfft(frames, n=n_fft, dim=-1))


def _mel_basis(wav, sample_rate, n_fft, n_mels, fmin, fmax) -> torch.Tensor:
    return _on_device(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax),
                      ("mel", sample_rate, n_fft, n_mels, fmin, fmax), wav.device)


def log10_mel(
    wav: torch.Tensor,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 80.0,
    fmax: float = 7600.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The binarizer's log10 mel of [..., T] -> [..., frames, n_mels]:
    librosa stft(pad_mode='constant') @ the Slaney mel basis, log10 clamped
    at eps (upstream data_gen_utils.py:122-134)."""
    spc = stft_magnitude(wav, n_fft, hop, win_length, center=True, pad_mode="constant")
    mel = torch.einsum("...tf,mf->...tm", spc, _mel_basis(wav, sample_rate, n_fft, n_mels, fmin, fmax))
    return torch.log10(torch.clamp(mel, min=eps))


def gan_log_mel(
    wav: torch.Tensor,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 80.0,
    fmax: float = 7600.0,
    clip_val: float = 1e-5,
) -> torch.Tensor:
    """HiFi-GAN's training-loss mel: reflect pad by (n_fft - hop) / 2,
    non-centered frames, natural-log compression."""
    pad = (n_fft - hop) // 2
    spc = stft_magnitude(_pad_last(wav, pad, pad, "reflect"), n_fft, hop, win_length, center=False)
    mel = torch.einsum("...tf,mf->...tm", spc, _mel_basis(wav, sample_rate, n_fft, n_mels, fmin, fmax))
    return torch.log(torch.clamp(mel, min=clip_val))


def librosa_pad_lr(x_len: int, fsize: int, fshift: int) -> tuple[int, int]:
    """Right-pad so the signal tiles exactly into hop-sized frames
    (upstream utils/audio.py librosa_pad_lr with pad_sides=1)."""
    pad = (x_len // fshift + 1) * fshift - x_len
    return 0, pad + fsize // 2  # matches (pad+2)//2*2 - pad//2 for even fsize


def batched_log10_mel(wav, sample_rate=22050, n_fft=1024, hop=256, win_length=1024, n_mels=80,
                      fmin=80.0, fmax=7600.0):
    """The binarizer's mel of a [B, T] batch in one pass (the JAX package's
    jitted ``batched_log10_mel``)."""
    return log10_mel(wav, sample_rate, n_fft, hop, win_length, n_mels, fmin, fmax)
