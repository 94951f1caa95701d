"""Probabilistic output losses: the discretized mixture of logistics, the
Gaussian NLL, and the Laplace sharpness of a spectrogram.

Port of ``dicttts_tpu/train/prob_losses.py``. The mixture sampler draws
its component (Gumbel-max over the logits) and its logistic noise from
the ``torch.Generator`` passed in.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def discretized_mix_logistic_loss(y_hat: torch.Tensor, y: torch.Tensor, num_classes: int = 256,
                                  log_scale_min: float = -7.0) -> torch.Tensor:
    """y_hat [B, T, 3 * n_mix] (logit_probs, means, log_scales); y [B, T, 1]
    in [-1, 1]. Returns the mean NLL."""
    n_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :n_mix]
    means = y_hat[..., n_mix:2 * n_mix]
    log_scales = torch.clamp(y_hat[..., 2 * n_mix:], min=log_scale_min)
    centered = y - means
    inv_std = torch.exp(-log_scales)
    half = 1.0 / (num_classes - 1)
    plus_in = inv_std * (centered + half)
    min_in = inv_std * (centered - half)
    log_cdf_plus = plus_in - F.softplus(plus_in)  # log sigmoid
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid_in = inv_std * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    log_probs = torch.where(y < -0.999, log_cdf_plus,
                            torch.where(y > 0.999, log_one_minus_cdf_min, inner))
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    return -torch.mean(torch.logsumexp(log_probs, dim=-1))


def sample_from_mix_logistic(y_hat: torch.Tensor, generator: torch.Generator | None = None,
                             log_scale_min: float = -7.0) -> torch.Tensor:
    """One sample in [-1, 1] per [B, T] position of y_hat [B, T, 3 * n_mix]."""
    n_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :n_mix]
    g = torch.rand(logit_probs.shape, generator=generator, device=y_hat.device)
    comp = torch.argmax(logit_probs - torch.log(-torch.log(g.clamp(min=1e-20))), dim=-1)
    onehot = F.one_hot(comp, n_mix).to(y_hat.dtype)
    means = torch.sum(y_hat[..., n_mix:2 * n_mix] * onehot, -1)
    log_scales = torch.clamp(torch.sum(y_hat[..., 2 * n_mix:] * onehot, -1), min=log_scale_min)
    u = 1e-5 + (1 - 2e-5) * torch.rand(means.shape, generator=generator, device=y_hat.device)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)


def gaussian_nll(mean: torch.Tensor, log_std: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Diagonal Gaussian negative log likelihood, mean-reduced."""
    return torch.mean(0.5 * (math.log(2 * math.pi) + 2 * log_std
                             + torch.exp(-2 * log_std) * torch.square(target - mean)))


def laplace_sharpness(mel: torch.Tensor) -> torch.Tensor:
    """Mean |Laplacian| of [B, T, M] spectrograms (a 3 x 3 kernel, VALID)."""
    kernel = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                          dtype=mel.dtype, device=mel.device)
    return torch.mean(torch.abs(F.conv2d(mel[:, None], kernel[None, None])))
