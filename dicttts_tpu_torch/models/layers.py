"""Transformer layers of the Dict-TTS encoders.

Port of ``dicttts_tpu/models/layers.py``: ``LayerNorm``, ``ConvFFN``,
``RelMultiHeadAttention`` and ``RelTransformerLayers``, for the
``window_size=None`` configuration the DictEncoder uses. Inputs and outputs
are feature-last ``[B, T, C]``. Dropout acts only in training mode and
draws its masks from the ``torch.Generator`` passed to ``forward``, so a
training step repeats from a seed. Parameter names follow the reference torch
encoder (``attn_layers.{i}.conv_q``, ``norm_layers_1.{i}.gamma``, ...), so
``dicttts_tpu.utils.torch_convert.convert_encoder_layers`` reads a
``state_dict`` of this module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

MASK_VALUE = -1e4  # attention-score mask of the reference encoder


def keep_mask(shape, p: float, generator: torch.Generator | None, device) -> torch.Tensor:
    """f32 dropout keep-scale: 1/(1-p) with probability 1-p, else 0 (the
    mask flax's ``nn.Dropout`` applies). Needs an explicit generator."""
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep = 1.0 - p
    return (torch.rand(shape, generator=generator, device=device) < keep).float() / keep


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Elementwise dropout, active only when ``training`` and ``p > 0``."""
    if not training or p == 0.0:
        return x
    return x * keep_mask(x.shape, p, generator, x.device).to(x.dtype)


def conv1d_tc(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """Apply a Conv1d to a feature-last [B, T, C] tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def linear_1x1(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """A kernel-1 Conv1d applied as a dense layer on [..., C]."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class LayerNorm(nn.Module):
    """Feature-axis layer norm (eps 1e-4), statistics in f32."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + self.eps)
        return (xf * self.gamma + self.beta).to(x.dtype)


class ConvFFN(nn.Module):
    """conv-k -> relu -> conv-1, masked before each conv and after."""

    def __init__(self, in_channels: int, filter_channels: int, out_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # x: [B, T, C]; x_mask: [B, T, 1]
        x = torch.relu(conv1d_tc(x * x_mask, self.conv_1))
        x = dropout(x, self.p_dropout, self.training, generator)
        return linear_1x1(x * x_mask, self.conv_2) * x_mask


class RelMultiHeadAttention(nn.Module):
    """Multi-head self-attention (no relative window): scores qk/sqrt(d) in
    f32, masked with -1e4, softmax, dropout on the weights, heads merged,
    output projection."""

    def __init__(self, channels: int, n_heads: int, p_dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.p_dropout = p_dropout
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # x: [B, T, C]; attn_mask: [B, T, T] (1 = attend)
        B, T, C = x.shape
        H = self.n_heads
        d = C // H

        def heads(conv):
            return linear_1x1(x, conv).reshape(B, T, H, d).transpose(1, 2)

        q, k, v = heads(self.conv_q), heads(self.conv_k), heads(self.conv_v)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(d)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[:, None] == 0, MASK_VALUE)
        p_attn = dropout(torch.softmax(scores, dim=-1), self.p_dropout, self.training, generator)
        out = torch.matmul(p_attn.to(v.dtype), v)
        return linear_1x1(out.transpose(1, 2).reshape(B, T, C), self.conv_o)


class RelTransformerLayers(nn.Module):
    """Pre-LN stack of [self-attention + conv FFN] blocks with a last LN
    (the reference ``Encoder`` with ``window_size=None``)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int = 1, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList(
            RelMultiHeadAttention(hidden_channels, n_heads, p_dropout) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            ConvFFN(hidden_channels, filter_channels, hidden_channels, kernel_size, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.last_ln = LayerNorm(hidden_channels)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # x: [B, T, C]; x_mask: [B, T, 1]
        m = x_mask[:, :, 0]
        attn_mask = m[:, None, :] * m[:, :, None]
        x_mask = x_mask.to(x.dtype)
        for attn, ln1, ffn, ln2 in zip(self.attn_layers, self.norm_layers_1,
                                       self.ffn_layers, self.norm_layers_2):
            x = x * x_mask
            y = attn(ln1(x), attn_mask, generator)
            x = x + dropout(y, self.p_dropout, self.training, generator)
            y = ffn(ln2(x), x_mask, generator)
            x = x + dropout(y, self.p_dropout, self.training, generator)
        return self.last_ln(x) * x_mask
