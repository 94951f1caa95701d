"""Residual affine coupling flow, the FVAE prior.

Port of ``dicttts_tpu/models/flows.py`` (mean-only coupling, WN coupling
net): forward (z_q -> z_p, for the KL in training) and reverse (sampling).
Runs in f32, with autocast off inside under amp (``ops/amp.f32_island``),
as the JAX module shields itself from the bf16 activation dtype. Parameter names follow the reference
(``flows.{2i}.pre/enc/post``; the odd slots are parameter-free channel
flips), which ``convert_coupling_block`` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from dicttts_tpu_torch.models.layers import linear_1x1
from dicttts_tpu_torch.ops.amp import f32_island
from dicttts_tpu_torch.models.wavenet import WN


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int = 1, n_layers: int = 4, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = nn.Conv1d(hidden_channels, self.half, 1)

    def _mean(self, x0: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
        h = linear_1x1(x0, self.pre) * x_mask
        h = self.enc(h, x_mask, g)
        return linear_1x1(h, self.post) * x_mask

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        # x: [B, T, C]; x_mask: [B, T, 1]; mean-only: x1 <- (m + x1) * mask
        x0, x1 = x[..., :self.half], x[..., self.half:]
        return torch.cat([x0, (self._mean(x0, x_mask, g) + x1) * x_mask], dim=-1)

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        # x: [B, T, C]; x_mask: [B, T, 1]; mean-only: x1 <- (x1 - m) * mask
        x0, x1 = x[..., :self.half], x[..., self.half:]
        return torch.cat([x0, (x1 - self._mean(x0, x_mask, g)) * x_mask], dim=-1)


class Flip(nn.Module):
    """Channel-order reversal between coupling layers (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flip(x, dims=[-1])


class ResidualCouplingBlock(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int = 1, n_layers: int = 4, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        flows = []
        for _ in range(n_flows):
            flows.append(ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                               dilation_rate, n_layers, gin_channels))
            flows.append(Flip())
        self.flows = nn.ModuleList(flows)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """Forward flow: z -> z_p, each coupling layer followed by its flip."""
        x, x_mask = x.float(), x_mask.float()
        g = None if g is None else g.float()
        with f32_island(x.device.type):
            for i in range(0, len(self.flows), 2):
                x = self.flows[i](x, x_mask, g)
                x = self.flows[i + 1](x)
        return x

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """Inverse flow: z_p -> z, undoing coupling layers last to first."""
        x, x_mask = x.float(), x_mask.float()
        g = None if g is None else g.float()
        with f32_island(x.device.type):
            for i in reversed(range(0, len(self.flows), 2)):
                x = self.flows[i + 1](x)
                x = self.flows[i].reverse(x, x_mask, g)
        return x
