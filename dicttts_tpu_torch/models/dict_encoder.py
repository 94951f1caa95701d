"""Semantics-to-pronunciation attention (S2PA) and the DictEncoder.

Port of ``dicttts_tpu/models/dict_encoder.py`` for the released model's
``token`` sense mode, in training and inference. ``S2PAAttention`` has the
three branches of the JAX module:

- bank: ``keys`` is the un-gathered ``[V, L, E]`` device bank, and the
  gather-fused kernels pick rows by word id: K1 forward, K2 backward
  (``ops/s2pa_bank.py::s2pa_bank_attend``); dropout is the keep-scale mask
  K1 applies to the weights;
- fused: gathered ``[B, T, L, E]`` banks with ``use_pallas``, in eval mode
  only: k and v are projected to H, then the fused kernel K3
  (``ops/s2pa_fused.py``);
- eager: gathered banks otherwise: plain tensor code with the q -> E
  reassociation.

In every branch the sense remap reads the weights after dropout. Dropout
acts in training mode only, with masks drawn from the ``torch.Generator``
passed to ``forward``.

Parameter names follow the reference torch modules (``q_transform``,
``S2PA_module.word_emb``, ...), which ``dicttts_tpu.utils.torch_convert``
reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from dicttts_tpu_torch.models.layers import RelTransformerLayers, dropout, keep_mask
from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_attend
from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused

S2PA_MASK_VALUE = -1e9
KEY_SIZE = 768  # the reference scales q by key_size**-0.5 with key_size fixed at 768


class DictMsg(NamedTuple):
    """Dict-bank tensors: keys/values [B, T, L, E] (or the [V, L, E] bank,
    with values the same tensor), key_map [B, T, L], pinyin [B, T, P],
    pinyin_map [B, T, P] (sense ids 1-based, 0 = pad)."""

    keys: torch.Tensor
    values: torch.Tensor
    key_map: torch.Tensor
    pinyin: torch.Tensor
    pinyin_map: torch.Tensor


def sense_remap(weights: torch.Tensor, key_map: torch.Tensor, pinyin_map: torch.Tensor) -> torch.Tensor:
    """out[b,t,p] = sum_l weights[b,t,l] * 1[key_map[b,t,l] == pinyin_map[b,t,p] != 0]."""
    same = (key_map[:, :, :, None] == pinyin_map[:, :, None, :]) & (pinyin_map[:, :, None, :] != 0)
    return torch.einsum("btl,btlp->btp", weights, same.to(weights.dtype))


def apply_pron_rule(pron_weights: torch.Tensor, pinyin_map: torch.Tensor,
                    pron_modified: torch.Tensor) -> torch.Tensor:
    """Where pron_modified[b,t] = i > 0 the forward value becomes the
    indicator of sense i over pinyin slots; gradients pass straight through
    to the soft weights."""
    rule = pron_modified > 0
    hard = (pinyin_map == pron_modified[:, :, None]).to(pron_weights.dtype)
    delta = torch.where(rule[:, :, None], hard - pron_weights, 0.0)
    return pron_weights + delta.detach()


class S2PAAttention(nn.Module):
    """Per-character attention over its own dictionary gloss tokens, plus
    the pronunciation head."""

    def __init__(self, query_size: int, dict_embed_dim: int = 768, pinyin_vocab: int = 185,
                 use_pallas: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.use_pallas = use_pallas
        self.dropout_rate = dropout_rate
        self.q_transform = nn.Linear(query_size, query_size, bias=False)
        self.k_transform = nn.Linear(dict_embed_dim, query_size, bias=False)
        self.v_transform = nn.Linear(dict_embed_dim, query_size, bias=False)
        self.output_transform = nn.Linear(query_size, query_size, bias=False)
        self.pinyin_embedding = nn.Embedding(pinyin_vocab, query_size)

    def forward(self, x: torch.Tensor, dict_msg: DictMsg, pron_modified: torch.Tensor | None = None,
                word_tokens: torch.Tensor | None = None, generator: torch.Generator | None = None):
        keys, values, key_map, pinyin, pinyin_map = dict_msg
        w_k, w_v = self.k_transform.weight, self.v_transform.weight  # [H, E]
        q = self.q_transform(x) * KEY_SIZE ** -0.5  # [B, T, H]

        if keys.ndim == 3:
            if values is not keys:
                raise ValueError("bank S2PA takes one bank: values must be keys")
            if word_tokens is None:
                raise ValueError("bank S2PA needs word ids")
            B, T = word_tokens.shape
            L, E = key_map.shape[-1], keys.shape[-1]
            q_e = torch.matmul(q, w_k.to(q.dtype))  # [B, T, E]
            if self.training and self.dropout_rate > 0.0:
                mask = keep_mask((B * T, L), self.dropout_rate, generator, x.device)
            else:
                mask = torch.ones((B * T, L), dtype=torch.float32, device=x.device)
            ctx_e, weights = s2pa_bank_attend(
                keys, word_tokens.reshape(-1).to(torch.int32).contiguous(),
                q_e.reshape(B * T, E).to(keys.dtype).contiguous(),
                key_map.reshape(B * T, L).to(torch.int32).contiguous(), mask,
            )
            weights = weights.reshape(B, T, L)
            context = F.linear(ctx_e.reshape(B, T, E).to(q.dtype), w_v.to(q.dtype))
            # the kernel's context used weights * mask; so does the remap
            pron_weights = sense_remap(weights * mask.reshape(B, T, L), key_map, pinyin_map)
        elif self.use_pallas and not self.training:  # K3 has no backward
            k = F.linear(keys, w_k)  # [B, T, L, H]
            v = F.linear(values, w_v)
            context, weights, pron_weights = s2pa_fused(
                q.contiguous(), k.contiguous(), v.contiguous(),
                key_map.to(torch.int32).contiguous(), pinyin_map.to(torch.int32).contiguous(),
            )
        else:
            keys = keys.to(q.dtype)
            values = values.to(q.dtype)
            q_e = torch.matmul(q, w_k.to(q.dtype))  # q in bank space
            logits = torch.einsum("btle,bte->btl", keys, q_e).float()
            logits = torch.where(key_map != 0, logits, S2PA_MASK_VALUE)
            weights = torch.softmax(logits, dim=-1)
            weights_d = dropout(weights, self.dropout_rate, self.training, generator)
            ctx_e = torch.einsum("btl,btle->bte", weights_d.to(values.dtype), values)
            context = F.linear(ctx_e, w_v.to(ctx_e.dtype))
            pron_weights = sense_remap(weights_d, key_map, pinyin_map)
        context = self.output_transform(context)

        pinyin_emb = self.pinyin_embedding(pinyin.long()) * (pinyin != 0).to(x.dtype)[..., None]
        if pron_modified is not None:
            pron_weights = apply_pron_rule(pron_weights, pinyin_map, pron_modified)
        pron = torch.einsum("btp,btph->bth", pron_weights.to(pinyin_emb.dtype), pinyin_emb)
        return context, weights, pron, pron_weights


class S2PATextEncoder(nn.Module):
    """word_emb -> semantic encoder -> S2PA -> (context + pron) ->
    linguistic encoder; both encoders without a relative window."""

    def __init__(self, word_vocab: int, hidden_channels: int, filter_channels: int, n_heads: int,
                 kernel_size: int, n_layers: int = 4, pinyin_vocab: int = 185,
                 dict_embed_dim: int = 768, use_pallas: bool = False, p_dropout: float = 0.0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.word_emb = nn.Embedding(word_vocab, hidden_channels)
        self.semantic_encoder = RelTransformerLayers(
            hidden_channels, filter_channels, n_heads, n_layers, kernel_size, p_dropout)
        self.s2pa_attention = S2PAAttention(hidden_channels, dict_embed_dim, pinyin_vocab, use_pallas,
                                            p_dropout)
        self.linguistic_encoder = RelTransformerLayers(
            hidden_channels, filter_channels, n_heads, n_layers, kernel_size, p_dropout)

    def forward(self, word_tokens, dict_msg, pron_modified=None, generator=None):
        x = self.word_emb(word_tokens.long()) * math.sqrt(self.hidden_channels)
        x_mask = (word_tokens > 0).to(x.dtype)[:, :, None]
        x = self.semantic_encoder(x, x_mask, generator)
        context, dict_attn, pron, pron_align = self.s2pa_attention(
            x, dict_msg, pron_modified, word_tokens=word_tokens, generator=generator)
        context = context * x_mask
        x = self.linguistic_encoder(context + pron, x_mask, generator)
        return x, dict_attn, pron_align, context


class DictEncoder(nn.Module):
    """Masked wrapper around S2PATextEncoder (FFN width 4 * hidden)."""

    def __init__(self, word_vocab: int, hidden_size: int, num_heads: int = 2,
                 ffn_kernel_size: int = 5, pinyin_vocab: int = 185, dict_embed_dim: int = 768,
                 use_pallas: bool = False, dropout: float = 0.0):
        super().__init__()
        self.S2PA_module = S2PATextEncoder(
            word_vocab, hidden_size, hidden_size * 4, num_heads, ffn_kernel_size,
            pinyin_vocab=pinyin_vocab, dict_embed_dim=dict_embed_dim,
            use_pallas=use_pallas, p_dropout=dropout)

    def forward(self, word_tokens, dict_msg, pron_modified=None, generator=None):
        x, dict_attn, pron_attn, context = self.S2PA_module(word_tokens, dict_msg, pron_modified,
                                                            generator)
        nonpadding = (word_tokens > 0).to(x.dtype)[:, :, None]
        return x * nonpadding, dict_attn, pron_attn, context
