"""Conformer blocks for the FastSpeech2 encoder and decoder registry.

Port of ``dicttts_tpu/models/conformer.py``: each block is a half-step
feed-forward, pre-LN self-attention (no relative window), the convolution
module (LayerNorm -> pointwise to 2C -> GLU -> depthwise conv on the masked
input -> LayerNorm -> SiLU -> pointwise), a second half-step feed-forward
and a last LayerNorm, masked. Feature-last ``[B, T, C]``; dropout acts in
training mode only and draws from the generator passed to ``forward``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dicttts_tpu_torch.models.layers import LayerNorm, RelMultiHeadAttention, conv1d_tc, dropout


class ConformerConvModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 9, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.ln1 = LayerNorm(channels)
        self.pw1 = nn.Linear(channels, 2 * channels)
        self.depthwise = nn.Conv1d(channels, channels, kernel_size, padding="same", groups=channels)
        self.ln2 = LayerNorm(channels)
        self.pw2 = nn.Linear(channels, channels)

    def forward(self, x, mask, generator=None):
        h = F.glu(self.pw1(self.ln1(x)), dim=-1)
        h = conv1d_tc(h * mask.to(h.dtype), self.depthwise)
        h = self.pw2(F.silu(self.ln2(h)))
        return dropout(h, self.dropout, self.training, generator)


class ConformerFF(nn.Module):
    def __init__(self, channels: int, expansion: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.ln = LayerNorm(channels)
        self.fc1 = nn.Linear(channels, channels * expansion)
        self.fc2 = nn.Linear(channels * expansion, channels)

    def forward(self, x, generator=None):
        h = dropout(F.silu(self.fc1(self.ln(x))), self.dropout, self.training, generator)
        return dropout(self.fc2(h), self.dropout, self.training, generator)


class ConformerBlock(nn.Module):
    def __init__(self, channels: int, n_heads: int = 2, kernel_size: int = 9, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.ff1 = ConformerFF(channels, dropout=dropout)
        self.ln_attn = LayerNorm(channels)
        self.attn = RelMultiHeadAttention(channels, n_heads)
        self.conv_module = ConformerConvModule(channels, kernel_size, dropout)
        self.ff2 = ConformerFF(channels, dropout=dropout)
        self.ln_out = LayerNorm(channels)

    def forward(self, x, nonpadding, generator=None):
        # x: [B, T, C]; nonpadding: [B, T] (1 = real)
        mask = nonpadding[:, :, None]
        attn_mask = nonpadding[:, None, :] * nonpadding[:, :, None]
        x = x + 0.5 * self.ff1(x, generator)
        h = self.attn(self.ln_attn(x), attn_mask, generator)
        x = x + dropout(h, self.dropout, self.training, generator)
        x = x + self.conv_module(x, mask, generator)
        x = x + 0.5 * self.ff2(x, generator)
        return self.ln_out(x) * mask.to(x.dtype)


class ConformerLayers(nn.Module):
    def __init__(self, channels: int, n_layers: int = 4, n_heads: int = 2, kernel_size: int = 9,
                 dropout: float = 0.1):
        super().__init__()
        self.blocks = nn.ModuleList(ConformerBlock(channels, n_heads, kernel_size, dropout)
                                    for _ in range(n_layers))

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, nonpadding, generator)
        return x
