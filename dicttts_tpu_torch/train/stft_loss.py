"""Multi-resolution STFT loss for vocoder training.

Port of ``dicttts_tpu/train/stft_loss.py``: at each (fft, hop, win)
resolution, the spectral convergence ||S_r - S_f||_F / ||S_r||_F and the
log-magnitude L1, each averaged over the three standard resolutions. The
magnitudes are ``ops/mel.stft_magnitude``'s (centered, zero-padded).
"""

from __future__ import annotations

import torch

from dicttts_tpu_torch.ops.mel import stft_magnitude
from dicttts_tpu_torch.parallel.mesh import global_sum, world_size

DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def spectral_convergence(mag_real: torch.Tensor, mag_fake: torch.Tensor) -> torch.Tensor:
    """||S_r - S_f||_F / ||S_r||_F over the (global) batch. Under data
    parallelism both norms are the global batch's: each rank returns
    sqrt(N) / D plus W times the first-order term of its own part of N
    (zero in the mean over ranks), so the ranks' mean is the global value
    and their averaged gradient the global gradient."""
    num2 = torch.sum(torch.square(mag_real - mag_fake))
    den = torch.clamp(torch.sqrt(global_sum(torch.sum(torch.square(mag_real)))), min=1e-8)
    root = torch.clamp(torch.sqrt(global_sum(num2)), min=1e-12)
    return (world_size() * (num2 - num2.detach()) / (2 * root) + root) / den


def log_stft_magnitude_loss(mag_real: torch.Tensor, mag_fake: torch.Tensor) -> torch.Tensor:
    eps = 1e-7
    return torch.mean(torch.abs(torch.log(mag_real + eps) - torch.log(mag_fake + eps)))


def stft_loss(wav_real, wav_fake, fft_size=1024, hop=120, win=600):
    mr = stft_magnitude(wav_real, fft_size, hop, win)
    mf = stft_magnitude(wav_fake, fft_size, hop, win)
    return spectral_convergence(mr, mf), log_stft_magnitude_loss(mr, mf)


def multi_resolution_stft_loss(wav_real, wav_fake, resolutions=DEFAULT_RESOLUTIONS):
    sc_total, mag_total = 0.0, 0.0
    for fft_size, hop, win in resolutions:
        sc, mag = stft_loss(wav_real, wav_fake, fft_size, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n
