"""Transformer layers of the Dict-TTS and PortaSpeech encoders.

Port of ``dicttts_tpu/models/layers.py``: ``LayerNorm``, ``ConvFFN``,
``RelMultiHeadAttention`` (with or without the heads-shared relative
window), the pre-LN ``RelTransformerLayers``, the ``ConvReluNorm`` prenet
and ``RelTransformerEncoder``. Inputs and outputs are feature-last
``[B, T, C]``. Dropout acts only in training mode and draws its masks from
the ``torch.Generator`` passed to ``forward``, so a training step repeats
from a seed. Parameter names follow the reference torch encoder
(``attn_layers.{i}.conv_q``, ``attn_layers.{i}.emb_rel_k``,
``norm_layers_1.{i}.gamma``, ``pre.conv_layers.{i}``, ``emb``, ...), so
``dicttts_tpu.utils.torch_convert.convert_encoder_layers`` and
``convert_rel_encoder`` read a ``state_dict`` of these modules.

The relative window w: scores get q . rel_k[j - i + w] for |j - i| <= w,
computed as a [T, 2w+1] band and placed on the [T, T] grid
(``band_to_full``); the output gets the band of the attention weights
times rel_v (``full_to_band``). Band slots outside the sequence (every row
when T < w + 1) read 0.
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


def band_to_full(band: torch.Tensor, length: int) -> torch.Tensor:
    """[..., T, 2w+1] relative band -> [..., T, T]: full[..., i, j] =
    band[..., i, j - i + w] for |j - i| <= w, else 0."""
    w = (band.shape[-1] - 1) // 2
    i = torch.arange(length, device=band.device)[:, None]
    m = torch.arange(length, device=band.device)[None, :] - i + w  # [T, T]
    valid = (m >= 0) & (m <= 2 * w)
    idx = m.clamp(0, 2 * w).expand(*band.shape[:-2], length, length)
    full = torch.gather(band, -1, idx)
    return torch.where(valid, full, torch.zeros((), dtype=full.dtype, device=full.device))


def full_to_band(full: torch.Tensor, window: int) -> torch.Tensor:
    """[..., T, T] -> [..., T, 2w+1]: band[..., i, m] = full[..., i, i + m - w]
    where that column lies in the sequence, else 0."""
    length = full.shape[-1]
    i = torch.arange(length, device=full.device)[:, None]
    j = i + torch.arange(2 * window + 1, device=full.device)[None, :] - window  # [T, 2w+1]
    valid = (j >= 0) & (j < length)
    idx = j.clamp(0, length - 1).expand(*full.shape[:-2], length, 2 * window + 1)
    band = torch.gather(full, -1, idx)
    return torch.where(valid, band, torch.zeros((), dtype=band.dtype, device=band.device))


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
    """Multi-head self-attention: scores qk/sqrt(d) in f32, plus with a
    window w the heads-shared relative scores q . rel_k / sqrt(d), masked
    with -1e4, softmax, dropout on the weights, heads merged (plus the
    weights' band times rel_v), output projection."""

    def __init__(self, channels: int, n_heads: int, p_dropout: float = 0.0,
                 window_size: int | None = None):
        super().__init__()
        self.n_heads = n_heads
        self.p_dropout = p_dropout
        self.window_size = window_size
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        if window_size is not None:
            d = channels // n_heads
            self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, d) * d ** -0.5)
            self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, d) * d ** -0.5)

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
        if self.window_size is not None:
            rel_band = torch.matmul(q, self.emb_rel_k[0].to(q.dtype).t()).float() / math.sqrt(d)
            scores = scores + band_to_full(rel_band, T)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask[:, None] == 0, MASK_VALUE)
        p_attn = dropout(torch.softmax(scores, dim=-1), self.p_dropout, self.training, generator)
        out = torch.matmul(p_attn.to(v.dtype), v)
        if self.window_size is not None:
            band_w = full_to_band(p_attn, self.window_size).to(v.dtype)
            out = out + torch.matmul(band_w, self.emb_rel_v[0].to(v.dtype))
        return linear_1x1(out.transpose(1, 2).reshape(B, T, C), self.conv_o)


class RelTransformerLayers(nn.Module):
    """Pre-LN stack of [self-attention + conv FFN] blocks with a last LN
    (the reference ``Encoder``; ``window_size`` None for the DictEncoder,
    4 for PortaSpeech's phone encoder)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int = 1, p_dropout: float = 0.0, window_size: int | None = None):
        super().__init__()
        self.p_dropout = p_dropout
        self.attn_layers = nn.ModuleList(
            RelMultiHeadAttention(hidden_channels, n_heads, p_dropout, window_size)
            for _ in range(n_layers))
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


class ConvReluNorm(nn.Module):
    """Residual conv prenet: n_layers of [conv-k on the masked input,
    LayerNorm, relu, dropout], then a kernel-1 projection (zero at
    initialisation) added to the input, masked."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 kernel_size: int = 5, n_layers: int = 3, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(in_channels if i == 0 else hidden_channels, hidden_channels, kernel_size,
                      padding=kernel_size // 2) for i in range(n_layers))
        self.norm_layers = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.proj = nn.Conv1d(hidden_channels, out_channels, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # x: [B, T, C]; x_mask: [B, T, 1]
        x_mask = x_mask.to(x.dtype)
        x_org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = torch.relu(norm(conv1d_tc(x * x_mask, conv)))
            x = dropout(x, self.p_dropout, self.training, generator)
        return (x_org + linear_1x1(x, self.proj)) * x_mask


class RelTransformerEncoder(nn.Module):
    """Token embedding (scaled by sqrt(H), pad id 0), the ConvReluNorm
    prenet (3 layers, kernel 5) and a pre-LN windowed transformer. tokens
    [B, T] -> [B, T, H], zero at pads."""

    def __init__(self, n_vocab: int, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 5, p_dropout: float = 0.0,
                 window_size: int | None = 4, prenet: bool = True):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        nn.init.normal_(self.emb.weight, 0.0, hidden_channels ** -0.5)
        self.pre = (ConvReluNorm(hidden_channels, hidden_channels, hidden_channels, 5, 3)
                    if prenet else None)
        self.encoder = RelTransformerLayers(hidden_channels, filter_channels, n_heads, n_layers,
                                            kernel_size, p_dropout, window_size)

    def forward(self, tokens: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.emb(tokens.long()) * math.sqrt(self.hidden_channels)
        x_mask = (tokens > 0).to(x.dtype)[:, :, None]
        if self.pre is not None:
            x = self.pre(x, x_mask, generator)
        return self.encoder(x, x_mask, generator)
