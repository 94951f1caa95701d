"""Continuous wavelet transform of f0 (the binarizer's ``with_f0cwt`` items).

Port of ``dicttts_tpu/ops/cwt.py`` (numpy, copied): f0 interpolated
through unvoiced frames, log-f0, a 10-scale Mexican-hat (DOG m=2) CWT with
dt=0.005, dj=1, s0=2dt, J=9 by the Torrence & Compo FFT method, per-scale
z-normalization, and the upstream approximate recomposition
``inverse_cwt`` with fixed scale weights.
"""

from __future__ import annotations

import math

import numpy as np

DT = 0.005
DJ = 1.0
S0 = 2 * DT
J = 9


def convert_continuous_f0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Zero-valued (unvoiced) frames -> linear interpolation between voiced
    neighbors; start/end padded with the first/last voiced value. Returns
    (uv mask, continuous f0)."""
    f0 = np.asarray(f0, np.float64).copy()
    uv = (f0 != 0).astype(np.float32)
    nz = np.where(f0 != 0)[0]
    if len(nz) == 0:
        return uv, f0
    f0[: nz[0]] = f0[nz[0]]
    f0[nz[-1]:] = f0[nz[-1]]
    nz = np.where(f0 != 0)[0]
    cont = np.interp(np.arange(len(f0)), nz, f0[nz])
    return uv, cont


def get_cont_lf0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    uv, cont = convert_continuous_f0(f0)
    with np.errstate(divide="ignore"):
        lf0 = np.log(np.maximum(cont, 1e-8))
    return uv, lf0


def cwt_mexican_hat(x: np.ndarray, dt: float = DT, dj: float = DJ,
                    s0: float = S0, j: int = J) -> tuple[np.ndarray, np.ndarray]:
    """[T] signal -> ([T, j+1] real CWT, scales). Torrence & Compo FFT
    method with the DOG m=2 (Mexican hat) wavelet."""
    x = np.asarray(x, np.float64)
    n = len(x)
    x_hat = np.fft.fft(x - x.mean())
    omega = 2 * np.pi * np.fft.fftfreq(n, dt)
    scales = s0 * 2.0 ** (dj * np.arange(j + 1))
    m = 2
    norm_const = 1.0 / math.sqrt(math.gamma(m + 0.5))
    out = np.zeros((n, j + 1))
    for i, s in enumerate(scales):
        sw = s * omega
        psi_hat = norm_const * (sw**m) * np.exp(-(sw**2) / 2.0)
        # energy normalization sqrt(2*pi*s/dt)
        w = np.fft.ifft(x_hat * psi_hat * math.sqrt(2 * math.pi * s / dt))
        out[:, i] = np.real(w)
    return out, scales


def norm_scale(wavelet: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-scale z-normalization (upstream norm_scale)."""
    mean = wavelet.mean(0)[None, :]
    std = np.maximum(wavelet.std(0)[None, :], 1e-8)
    return (wavelet - mean) / std, mean, std


def inverse_cwt(wavelet_norm: np.ndarray, n_scales: int = J + 1) -> np.ndarray:
    """Approximate recomposition with the upstream fixed scale weights
    (utils/cwt.py inverse_cwt): sum_j W[:, j] * (j + 3.5)^-2.5, z-normed."""
    b = (np.arange(n_scales)[None, :] + 1 + 2.5) ** (-2.5)
    rec = (wavelet_norm * b).sum(-1)
    return (rec - rec.mean()) / np.maximum(rec.std(), 1e-8)


def f0_cwt(f0: np.ndarray) -> dict:
    """f0 [T] -> {'cwt_spec' [T, 10], 'cwt_mean'/'cwt_std' [10], 'uv' [T]}
    (the binarizer's with_f0cwt feature, base_binarizer.py:259-272)."""
    uv, lf0 = get_cont_lf0(f0)
    lf0_norm = (lf0 - lf0.mean()) / max(lf0.std(), 1e-8)
    wavelet, _ = cwt_mexican_hat(lf0_norm)
    wavelet_norm, mean, std = norm_scale(wavelet)
    return {
        "cwt_spec": wavelet_norm.astype(np.float32),
        "cwt_mean": mean[0].astype(np.float32),
        "cwt_std": std[0].astype(np.float32),
        "uv": uv,
    }
