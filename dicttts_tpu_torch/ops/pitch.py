"""Host-side f0 preprocessing for the dataset.

Port of ``norm_f0`` and ``norm_interp_f0`` from ``dicttts_tpu/ops/pitch.py``
(numpy only): the unvoiced mask, linear interpolation of f0 through the
unvoiced frames, then normalisation ('log': log2; 'standard':
(f0 - mean) / std).
"""

from __future__ import annotations

import numpy as np


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
