"""Frame-level VAE mel decoder with a residual-coupling prior.

Port of ``dicttts_tpu/models/fvae.py``. Training (``FVAE.forward``): the
posterior encoder reads the target mel, samples z_q, the decoder rebuilds
the mel from it, and the KL term holds z_q against the prior through the
forward flow, reduced in f32. Inference (``FVAE.infer``): the prior latent
is drawn (or given), run backwards through the prior flow conditioned on
the strided word-state conditioning, and decoded to mel frames. Without
the flow (``use_prior_flow=False``, the config's ``use_prior_glow:
false``) the prior is the standard normal itself: the KL is the closed
form KL(N(m_q, exp(logs_q)) || N(0, 1)) and the sample is decoded as
drawn. The KL runs with autocast off (``ops/amp.f32_island``). The
posterior's noise is drawn from a ``torch.Generator`` or passed in as
``eps``. No dropout, as in the JAX package. Parameter names follow the reference (``g_pre_net.0``,
``decoder.pre_net.0``, ``decoder.wn``, ...), which ``convert_fvae`` reads.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from dicttts_tpu_torch.models.flows import ResidualCouplingBlock
from dicttts_tpu_torch.models.layers import linear_1x1
from dicttts_tpu_torch.models.wavenet import WN
from dicttts_tpu_torch.ops.amp import f32_island
from dicttts_tpu_torch.parallel.mesh import shard_denominator

LOG2PI = math.log(2 * math.pi)


def normal_log_prob(x: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor) -> torch.Tensor:
    return -0.5 * (LOG2PI + 2 * log_std + torch.exp(-2 * log_std) * torch.square(x - mean))


def standard_normal_log_prob(x: torch.Tensor) -> torch.Tensor:
    return -0.5 * (LOG2PI + torch.square(x))


def normal_kl_to_standard(mean: torch.Tensor, log_std: torch.Tensor) -> torch.Tensor:
    """KL(N(mean, exp(log_std)) || N(0, 1)), elementwise."""
    return 0.5 * (torch.exp(2 * log_std) + torch.square(mean) - 1.0) - log_std


def strided_prenet(in_channels: int, hidden_channels: int, strides: Sequence[int]) -> nn.ModuleList:
    """Stride-s convs (kernel 2s, pad s/2): length T -> T / prod(s)."""
    return nn.ModuleList(
        nn.Conv1d(in_channels if i == 0 else hidden_channels, hidden_channels, 2 * s,
                  stride=s, padding=s // 2)
        for i, s in enumerate(strides))


def run_prenet(x: torch.Tensor, convs: nn.ModuleList) -> torch.Tensor:
    """Apply a conv stack to feature-last [B, T, C]."""
    x = x.transpose(1, 2)
    for conv in convs:
        x = conv(x)
    return x.transpose(1, 2)


class FVAEEncoder(nn.Module):
    """Posterior encoder (training only): strided prenet, WN, projection to
    the latent mean and log-std, reparameterised sample."""

    def __init__(self, in_channels: int, hidden_channels: int, latent_channels: int,
                 kernel_size: int, n_layers: int, gin_channels: int, strides: Sequence[int]):
        super().__init__()
        self.latent_channels = latent_channels
        self.stride = math.prod(strides)
        self.pre_net = strided_prenet(in_channels, hidden_channels, strides)
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels)
        self.out_proj = nn.Conv1d(hidden_channels, 2 * latent_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor,
                eps: torch.Tensor | None = None, generator: torch.Generator | None = None,
                noise_scale: float = 1.0):
        """x: [B, T, C_mel]; x_mask: [B, T, 1]; g: [B, T / stride, C_g].
        eps: optional [B, T / stride, latent] standard-normal sample (else
        drawn from ``generator``). Returns (z, m, logs, x_mask_sqz)."""
        x = run_prenet(x, self.pre_net)
        x_mask_sqz = x_mask[:, ::self.stride][:, :x.shape[1]].to(x.dtype)
        x = self.wn(x * x_mask_sqz, x_mask_sqz, g) * x_mask_sqz
        stats = linear_1x1(x, self.out_proj)
        m = stats[..., :self.latent_channels].float()
        logs = stats[..., self.latent_channels:].float()
        if eps is None:
            eps = torch.randn(m.shape, generator=generator, device=m.device, dtype=torch.float32)
        z = m + eps.float() * noise_scale * torch.exp(logs)
        return z, m, logs, x_mask_sqz


class FVAEDecoder(nn.Module):
    def __init__(self, latent_channels: int, hidden_channels: int, out_channels: int,
                 kernel_size: int, n_layers: int, gin_channels: int, strides: Sequence[int]):
        super().__init__()
        self.pre_net = nn.ModuleList(
            nn.ConvTranspose1d(latent_channels if i == 0 else hidden_channels, hidden_channels, s, stride=s)
            for i, s in enumerate(strides))
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels)
        self.out_proj = nn.Conv1d(hidden_channels, out_channels, 1)

    def forward(self, z: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        # z: [B, T_sqz, C_lat]; x_mask: [B, T, 1]; g: [B, T, C_g] -> [B, T, C_out]
        x = run_prenet(z, self.pre_net) * x_mask
        x = self.wn(x, x_mask, g) * x_mask
        return linear_1x1(x, self.out_proj)


class FVAE(nn.Module):
    def __init__(self, in_out_channels: int = 80, hidden_channels: int = 192, latent_size: int = 16,
                 kernel_size: int = 5, enc_n_layers: int = 8, dec_n_layers: int = 4,
                 gin_channels: int = 192, strides: Sequence[int] = (4,), flow_hidden: int = 64,
                 flow_kernel_size: int = 3, flow_n_steps: int = 4, use_prior_flow: bool = True):
        super().__init__()
        self.latent_size = latent_size
        self.stride = math.prod(strides)
        self.g_pre_net = strided_prenet(gin_channels, gin_channels, strides)
        self.encoder = FVAEEncoder(in_out_channels, hidden_channels, latent_size, kernel_size,
                                   enc_n_layers, gin_channels, strides)
        self.decoder = FVAEDecoder(latent_size, hidden_channels, in_out_channels, kernel_size,
                                   dec_n_layers, gin_channels, strides)
        # as the JAX module: flow_n_steps WN layers in each of 4 coupling layers
        self.prior_flow = (ResidualCouplingBlock(latent_size, flow_hidden, flow_kernel_size, 1,
                                                 flow_n_steps, 4, gin_channels=gin_channels)
                           if use_prior_flow else None)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor,
                eps: torch.Tensor | None = None, generator: torch.Generator | None = None,
                noise_scale: float = 1.0):
        """Training: x [B, T, C_out] target mel, x_mask [B, T, 1], g
        [B, T, C_g]. Returns (x_recon, loss_kl, z_p, m_q, logs_q); the KL is
        sum((log q(z_q) - log p(z_p)) * mask) / max(frames, 1) / latent, or
        without the flow sum(KL(q || N(0, 1)) * mask) / max(frames, 1) /
        latent, and then z_p is None."""
        g_sqz = run_prenet(g, self.g_pre_net)
        z_q, m_q, logs_q, x_mask_sqz = self.encoder(x, x_mask, g_sqz, eps, generator, noise_scale)
        x_recon = self.decoder(z_q, x_mask, g)
        mask_f32 = x_mask_sqz.float()
        frames = shard_denominator(torch.sum(mask_f32))  # the global frames over the world size
        with f32_island(z_q.device.type):
            if self.prior_flow is None:
                kl = normal_kl_to_standard(m_q, logs_q)
                return x_recon, torch.sum(kl * mask_f32) / frames / z_q.shape[-1], None, m_q, logs_q
            logqx = normal_log_prob(z_q, m_q, logs_q)
            z_p = self.prior_flow(z_q.float(), mask_f32, g_sqz)
            logpx = standard_normal_log_prob(z_p)
            loss_kl = torch.sum((logqx - logpx) * mask_f32) / frames / logqx.shape[-1]
        return x_recon, loss_kl, z_p, m_q, logs_q

    def infer(self, g: torch.Tensor, x_mask: torch.Tensor, noise: torch.Tensor | None = None,
              noise_scale: float = 1.0, generator: torch.Generator | None = None):
        """g: [B, T, C_g] word states at frame rate; x_mask: [B, T, 1].
        noise: optional [B, T / stride, latent] standard-normal sample (else
        drawn from ``generator`` on g's device). Returns (mel [B, T, C_out], z_p)."""
        g_sqz = run_prenet(g, self.g_pre_net)
        if noise is None:
            noise = torch.randn((g_sqz.shape[0], g_sqz.shape[1], self.latent_size),
                                generator=generator, device=g.device, dtype=torch.float32)
        z_p = noise_scale * noise.float()
        if self.prior_flow is not None:
            x_mask_sqz = x_mask[:, ::self.stride][:, :g_sqz.shape[1]]
            z_p = self.prior_flow.reverse(z_p, x_mask_sqz, g_sqz)
        return self.decoder(z_p, x_mask, g), z_p
