"""FastSpeech-style FFT transformer blocks with sinusoidal positions.

Port of ``dicttts_tpu/models/fft_blocks.py``: a sinusoidal position table
scaled by a learned alpha is added to the input, then n pre-LN layers of
[self-attention (no relative window), conv FFN (kernel k, 4H, gelu)] with
padding re-masked between sublayers, and a last LayerNorm. Feature-last
``[B, T, C]``. The JAX package has no torch converter for this module, so
``convert.fft_blocks_state`` names its parameters directly: ``pos_alpha``,
``ln1.{i}``, ``attn.{i}`` (``conv_q`` ... ``conv_o``), ``ln2.{i}``,
``ffn1.{i}`` (Conv1d), ``ffn2.{i}`` (Linear), ``ln_out``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dicttts_tpu_torch.models.layers import LayerNorm, RelMultiHeadAttention, conv1d_tc, dropout


def sinusoidal_positions(length: int, dim: int, offset: int = 1) -> np.ndarray:
    """Fairseq-style sinusoid table [length, dim], f32; positions start at
    ``offset`` (0 is the pad position)."""
    half = dim // 2
    emb = math.log(10000.0) / max(half - 1, 1)
    freqs = np.exp(np.arange(half) * -emb)
    pos = np.arange(offset, offset + length)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((length, 1))], axis=1)
    return table.astype(np.float32)


_TABLES: dict = {}


def position_table(length: int, dim: int, device, offset: int = 1) -> torch.Tensor:
    """``sinusoidal_positions(length, dim, offset)`` as a tensor on
    ``device``: a view of one table per (dim, offset, device), built on the
    host once and again only when a longer one is asked for (its rows do
    not depend on the length)."""
    key = (dim, offset, torch.device(device))
    table = _TABLES.get(key)
    if table is None or table.shape[0] < length:
        table = _TABLES[key] = torch.from_numpy(sinusoidal_positions(length, dim, offset)).to(device)
    return table[:length]


class FFTBlocks(nn.Module):
    def __init__(self, hidden_size: int, n_layers: int, ffn_kernel_size: int = 9, n_heads: int = 2,
                 dropout: float = 0.1, use_pos_embed: bool = True, ffn_act: str = "gelu"):
        super().__init__()
        H = hidden_size
        self.dropout = dropout
        self.ffn_act = ffn_act
        self.pos_alpha = nn.Parameter(torch.ones(1)) if use_pos_embed else None
        self.ln1 = nn.ModuleList(LayerNorm(H) for _ in range(n_layers))
        self.attn = nn.ModuleList(RelMultiHeadAttention(H, n_heads) for _ in range(n_layers))
        self.ln2 = nn.ModuleList(LayerNorm(H) for _ in range(n_layers))
        self.ffn1 = nn.ModuleList(nn.Conv1d(H, 4 * H, ffn_kernel_size, padding=ffn_kernel_size // 2)
                                  for _ in range(n_layers))
        self.ffn2 = nn.ModuleList(nn.Linear(4 * H, H) for _ in range(n_layers))
        self.ln_out = LayerNorm(H)

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # x: [B, T, C]; nonpadding: [B, T] (1 = real), from |x| when None
        if nonpadding is None:
            nonpadding = x.abs().sum(dim=-1) > 0
        nonpadding = nonpadding.to(x.dtype)
        mask = nonpadding[:, :, None]
        if self.pos_alpha is not None:
            table = position_table(x.shape[1], x.shape[2], x.device)
            x = x + (self.pos_alpha * table[None] * mask.float()).to(x.dtype)
            x = dropout(x, self.dropout, self.training, generator)
        attn_mask = nonpadding[:, None, :] * nonpadding[:, :, None]
        for ln1, attn, ln2, ffn1, ffn2 in zip(self.ln1, self.attn, self.ln2, self.ffn1, self.ffn2):
            x = x * mask
            h = dropout(attn(ln1(x), attn_mask, generator), self.dropout, self.training, generator)
            x = (x + h) * mask
            h = conv1d_tc(ln2(x) * mask, ffn1)
            h = F.gelu(h, approximate="tanh") if self.ffn_act == "gelu" else torch.relu(h)
            h = ffn2(dropout(h, self.dropout, self.training, generator))
            x = (x + h) * mask
        return self.ln_out(x) * mask
