"""Pitch utilities: host-side f0 preprocessing for the dataset, and the
coarse f0 buckets and de-normalisation of FastSpeech2's pitch path.

Port of ``dicttts_tpu/ops/pitch.py``:
- ``norm_f0`` and ``norm_interp_f0`` (numpy only): the unvoiced mask,
  linear interpolation of f0 through the unvoiced frames, then
  normalisation ('log': log2; 'standard': (f0 - mean) / std);
- ``f0_to_coarse`` and ``denorm_f0`` (torch): mel-scale (1127 ln(1 + f /
  700)) bucketing into 256 bins over [50, 1100] Hz, where 0 Hz (and any
  f0 whose mel is not positive) falls to bucket 1; and the inverse of the
  normalisation, clamped at 0, zeroed on unvoiced and padding frames.
"""

from __future__ import annotations

import numpy as np
import torch

F0_BIN = 256
F0_MIN, F0_MAX = 50.0, 1100.0
F0_MEL_MIN = 1127.0 * np.log(1 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1 + F0_MAX / 700.0)


def norm_f0(f0, uv=None, pitch_norm: str = "log", mean: float = 0.0, std: float = 1.0):
    if pitch_norm == "standard":
        out = (f0 - mean) / std
    elif pitch_norm == "log":
        out = np.log2(np.maximum(f0, 1e-8))
    else:
        out = f0
    if uv is not None:
        out = out * (1 - uv)
    return out


def norm_interp_f0(f0: np.ndarray, pitch_norm: str = "log", mean: float = 0.0, std: float = 1.0):
    """(normalized f0, uv mask), both float32 [T]: f0 interpolated through
    unvoiced (zero) frames, then normalized."""
    f0 = np.asarray(f0, np.float32)
    uv = (f0 == 0).astype(np.float32)
    if (uv < 1).any():
        voiced = np.where(uv < 1)[0]
        f0 = np.interp(np.arange(len(f0)), voiced, f0[voiced])
    f0 = norm_f0(f0, None, pitch_norm, mean, std)
    return f0.astype(np.float32), uv


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """f0 in Hz [...] (f32) -> int32 bucket ids in [1, 255]: the mel-scale
    value mapped linearly onto [1, 255], clipped, and truncated after
    adding 0.5."""
    f0_mel = 1127.0 * torch.log(1 + f0 / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1
    scaled = torch.where(f0_mel > 0, scaled, torch.zeros((), dtype=scaled.dtype, device=scaled.device))
    scaled = torch.clamp(scaled, 1.0, F0_BIN - 1)
    return (scaled + 0.5).to(torch.int32)


def denorm_f0(f0: torch.Tensor, uv: torch.Tensor | None = None, pitch_norm: str = "log",
              mean: float = 0.0, std: float = 1.0,
              pitch_padding: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized f0 -> Hz: the inverse of ``norm_f0``, clamped at 0, times
    (1 - uv) where ``uv`` is given, 0 where ``pitch_padding`` is true."""
    if pitch_norm == "standard":
        out = f0 * std + mean
    elif pitch_norm == "log":
        out = 2.0 ** f0
    else:
        out = f0
    out = torch.clamp(out, min=0.0)
    if uv is not None:
        out = out * (1 - uv)
    if pitch_padding is not None:
        out = torch.where(pitch_padding, torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out
