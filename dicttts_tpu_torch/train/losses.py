"""Losses of the Dict-TTS GAN step: composite mel loss, SSIM, GDL, word
durations, LSGAN and the KL clamp.

Port of ``dicttts_tpu/train/losses.py``. Masks follow the JAX package: a
mel frame counts where the target has any nonzero bin. Under data
parallelism the masked averages divide by the global batch's count over
the world size and the KL floor reads the global KL
(``parallel/mesh.py``), so the mean over ranks of each loss is the global
batch's, as the JAX package's sharded step computes it. SSIM blurs with the
11-tap gaussian (sigma 1.5) as two banded-Toeplitz matrix products, an
exact transform of the SAME-padded 11x11 conv2d; those products stay
``torch.matmul``, since no Pallas kernel computed them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dicttts_tpu_torch.ops.seq import mel2token_to_dur
from dicttts_tpu_torch.parallel.mesh import global_mean, shard_denominator


def parse_mel_loss_spec(spec: str) -> dict[str, float]:
    """'l1:0.5|ssim:0.5' -> {'l1': 0.5, 'ssim': 0.5}."""
    out: dict[str, float] = {}
    for part in spec.split("|"):
        if not part:
            continue
        if ":" in part:
            name, lbd = part.split(":")
            out[name] = float(lbd)
        else:
            out[part] = 1.0
    return out


def nonzero_mel_mask(target: torch.Tensor) -> torch.Tensor:
    """[B, T, M] -> [B, T, 1] 1.0 where the frame has any nonzero mel."""
    return (target.abs().sum(dim=-1, keepdim=True) > 0).float()


def _masked_average(err: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    w = w.expand_as(err)
    return torch.sum(err * w) / shard_denominator(torch.sum(w))


def masked_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _masked_average((pred - target).abs(), nonzero_mel_mask(target))


def masked_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _masked_average(torch.square(pred - target), nonzero_mel_mask(target))


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, device: str, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """[n, n] banded Toeplitz G with G[i, i+k] = g[k+half]: G @ x is the
    SAME-zero-padded 1-D gaussian conv along that axis. Kept for every n
    (a captured step reads it at each replay: evicting it would free
    memory a CUDA graph still reads)."""
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    half = window_size // 2
    m = np.zeros((n, n), np.float32)
    for k in range(-half, half + 1):
        m += np.eye(n, k=k, dtype=np.float32) * g[k + half]
    return torch.tensor(m, device=device)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """SSIM map over [B, T, M] single-channel images."""
    dev = str(img1.device)
    gt = _blur_matrix(img1.shape[1], dev, window_size)
    gm = _blur_matrix(img1.shape[2], dev, window_size)

    def conv(x):
        return torch.matmul(torch.matmul(gt, x), gm.T)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, bias: float = 6.0) -> torch.Tensor:
    """1 - SSIM on bias-shifted mels, masked-averaged."""
    return _masked_average(1.0 - _ssim_map(pred + bias, target + bias), nonzero_mel_mask(target))


def gdl_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Gradient-difference loss along the time and mel axes, masked."""
    w = nonzero_mel_mask(target)
    dt_p = (pred[:, 1:] - pred[:, :-1]).abs()
    dt_t = (target[:, 1:] - target[:, :-1]).abs()
    df_p = (pred[:, :, 1:] - pred[:, :, :-1]).abs()
    df_t = (target[:, :, 1:] - target[:, :, :-1]).abs()
    return _masked_average((dt_p - dt_t).abs(), w[:, 1:]) + _masked_average((df_p - df_t).abs(), w)


MEL_LOSS_FNS = {"l1": masked_l1, "mse": masked_mse, "ssim": ssim_loss, "gdl": gdl_loss}


def add_mel_losses(spec: dict[str, float], pred: torch.Tensor, target: torch.Tensor,
                   losses: dict, postfix: str = "") -> dict:
    for name, lbd in spec.items():
        losses[f"{name}{postfix}"] = MEL_LOSS_FNS[name](pred, target) * lbd
    return losses


def word_dur_loss(dur_pred: torch.Tensor, mel2word: torch.Tensor, word_lengths: torch.Tensor,
                  dur_scale: str = "log") -> torch.Tensor:
    """L1 between predicted (log-domain) and ground-truth word durations.
    dur_pred [B, T_w]; mel2word [B, T_mel]; word_lengths [B]."""
    T = dur_pred.shape[1]
    dur_gt = mel2token_to_dur(mel2word, T).float()
    nonpadding = (torch.arange(T, device=dur_pred.device)[None, :] < word_lengths[:, None]).float()
    if dur_scale == "log":
        dur_gt = torch.log(dur_gt + 1.0)
    diff = (dur_pred * nonpadding - dur_gt * nonpadding).abs()
    return torch.sum(diff) / shard_denominator(torch.sum(nonpadding))


def row_mean(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` [B, ...] over the rows whose ``lengths`` [B] are
    nonzero: a zero row, which pads a batch to the world size, counts for
    nothing. The count is the global batch's (``shard_denominator``)."""
    rows = (lengths > 0).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
    return torch.sum(x * rows) / shard_denominator(torch.sum(rows) * (x.numel() // x.shape[0]))


def lsgan_g_loss(disc_out: torch.Tensor) -> torch.Tensor:
    """Generator wants D(fake) -> 1."""
    return torch.mean(torch.square(disc_out - 1.0))


def lsgan_d_loss(real_out: torch.Tensor, fake_out: torch.Tensor) -> torch.Tensor:
    """Discriminator: real -> 1, fake -> 0."""
    return torch.mean(torch.square(real_out - 1.0)) + torch.mean(torch.square(fake_out))


def feature_matching_loss(fmaps_real, fmaps_fake) -> torch.Tensor:
    """HiFi-GAN's feature loss: 2 x the sum over the feature maps (nested
    lists, flattened in order) of mean |real - fake|."""
    def flat(x):
        return [t for item in x for t in flat(item)] if isinstance(x, (list, tuple)) else [x]

    return 2.0 * sum(torch.mean(torch.abs(r - f)) for r, f in zip(flat(fmaps_real), flat(fmaps_fake)))


def clamp_kl(kl: torch.Tensor, floor: float = 0.002) -> torch.Tensor:
    """KL floor: below it the term is constant and passes no gradient.
    Under data parallelism the floor applies to the global KL (the mean
    over ranks of ``kl``), so every rank takes the same side of it."""
    return torch.where(global_mean(kl) >= floor, kl, torch.full_like(kl, floor))
