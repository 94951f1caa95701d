"""Semantics-to-pronunciation attention (S2PA) and the DictEncoder.

Port of ``dicttts_tpu/models/dict_encoder.py``, in training and inference.
``S2PAAttention`` has the three branches of the JAX module:

- bank: ``keys`` is the un-gathered ``[V, L, E]`` device bank, and the
  gather-fused kernels pick rows by word id: K1 forward, K2 backward
  (``ops/s2pa_bank.py::s2pa_bank_attend``); dropout is the keep-scale mask
  K1 applies to the weights;
- fused: gathered ``[B, T, L, E]`` banks with ``use_pallas``, in eval mode
  and the ``token`` sense mode only: k and v are projected to H in f32,
  then the fused kernel K3 (``ops/s2pa_fused.py``);
- eager: gathered banks otherwise (and a device bank gathered by word id,
  ``s2pa_bank_fused: false``): plain tensor code with the q -> E
  reassociation.

In every branch the sense remap reads the weights after dropout. The sense
mode picks the remap: ``token`` (the released model) sums the attention
mass per sense id onto each pinyin slot (``sense_remap``); ``sense`` and
``gumbel`` first sum it per sense, renormalise over the senses (a softmax,
or a straight-through Gumbel softmax at ``gumbel_temperature``) and then
broadcast each sense's share onto its pinyin slots
(``sense_remap_grouped``). Dropout and the Gumbel noise act in training
mode only, drawn from the ``torch.Generator`` passed to ``forward``. Under
amp the softmax statistics and the remap run in f32 with autocast off, as
the JAX module keeps them f32.

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
from dicttts_tpu_torch.ops.amp import f32_island
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


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel samples -log(-log(u)), u uniform on [tiny, 1), f32,
    as ``jax.random.gumbel`` draws them. Needs an explicit generator."""
    if generator is None:
        raise ValueError("Gumbel noise in training mode needs a torch.Generator")
    u = torch.rand(shape, generator=generator, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_softmax(logits: torch.Tensor, temperature: float,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Hard straight-through Gumbel softmax over the last axis: the one-hot
    of the argmax of softmax((logits + noise) / temperature) in the forward
    value, gradients through the soft weights. ``noise`` None: no noise
    (eval)."""
    y = logits if noise is None else logits + noise.to(logits.dtype)
    y_soft = torch.softmax(y / temperature, dim=-1)
    y_hard = F.one_hot(y_soft.argmax(-1), logits.shape[-1]).to(logits.dtype)
    return y_soft + (y_hard - y_soft).detach()


def sense_remap_grouped(weights: torch.Tensor, key_map: torch.Tensor, pinyin_map: torch.Tensor,
                        max_senses: int, mode: str = "sense", temperature: float = 0.8,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """The sense-grouped remap: gloss-token weights [B, T, L] summed per
    sense id (1..max_senses, 0 = pad), renormalised over the senses a word
    has (``sense``: softmax; ``gumbel``: hard straight-through Gumbel
    softmax with ``noise`` [B, T, max_senses]), then broadcast onto each
    sense's pinyin slots -> [B, T, P]. A word with no sense gets zeros."""
    sense_ids = torch.arange(1, max_senses + 1, device=weights.device)
    key_oh = (key_map[..., None] == sense_ids).to(weights.dtype)  # [B, T, L, S]
    merged = torch.einsum("btl,btls->bts", weights, key_oh)
    has_sense = key_oh.sum(dim=2) > 0
    logits = torch.where(has_sense, merged, S2PA_MASK_VALUE)
    if mode == "gumbel":
        sel = gumbel_softmax(logits, temperature, noise)
    else:
        sel = torch.softmax(logits, dim=-1)
    sel = sel * has_sense.to(weights.dtype)
    pin_oh = (pinyin_map[..., None] == sense_ids).to(weights.dtype)  # [B, T, P, S]
    return torch.einsum("bts,btps->btp", sel, pin_oh)


def apply_pron_rule(pron_weights: torch.Tensor, pinyin_map: torch.Tensor,
                    pron_modified: torch.Tensor) -> torch.Tensor:
    """Where pron_modified[b,t] = i > 0 the forward value becomes the
    indicator of sense i over pinyin slots; gradients pass straight through
    to the soft weights."""
    rule = pron_modified > 0
    hard = (pinyin_map == pron_modified[:, :, None]).to(pron_weights.dtype)
    delta = torch.where(rule[:, :, None], hard - pron_weights, 0.0)
    return pron_weights + delta.detach()


SENSE_MODES = ("token", "sense", "gumbel")


class S2PAAttention(nn.Module):
    """Per-character attention over its own dictionary gloss tokens, plus
    the pronunciation head."""

    def __init__(self, query_size: int, dict_embed_dim: int = 768, pinyin_vocab: int = 185,
                 use_pallas: bool = False, dropout_rate: float = 0.0, sense_mode: str = "token",
                 max_senses: int = 10, gumbel_temperature: float = 0.8):
        super().__init__()
        if sense_mode not in SENSE_MODES:
            raise ValueError(f"s2pa_sense_mode must be one of {SENSE_MODES}, got {sense_mode!r}")
        self.use_pallas = use_pallas
        self.dropout_rate = dropout_rate
        self.sense_mode = sense_mode
        self.max_senses = max_senses
        self.gumbel_temperature = gumbel_temperature
        self.q_transform = nn.Linear(query_size, query_size, bias=False)
        self.k_transform = nn.Linear(dict_embed_dim, query_size, bias=False)
        self.v_transform = nn.Linear(dict_embed_dim, query_size, bias=False)
        self.output_transform = nn.Linear(query_size, query_size, bias=False)
        self.pinyin_embedding = nn.Embedding(pinyin_vocab, query_size)

    def _remap(self, weights_d: torch.Tensor, key_map: torch.Tensor, pinyin_map: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        """The sense mode's remap of the post-dropout weights, in f32."""
        with f32_island(weights_d.device.type):
            weights_d = weights_d.float()
            if self.sense_mode == "token":
                return sense_remap(weights_d, key_map, pinyin_map)
            noise = None
            if self.sense_mode == "gumbel" and self.training:
                noise = gumbel_noise((*weights_d.shape[:2], self.max_senses), generator,
                                     weights_d.device)
            return sense_remap_grouped(weights_d, key_map, pinyin_map, self.max_senses,
                                       self.sense_mode, self.gumbel_temperature, noise)

    def forward(self, x: torch.Tensor, dict_msg: DictMsg, pron_modified: torch.Tensor | None = None,
                word_tokens: torch.Tensor | None = None, generator: torch.Generator | None = None):
        keys, values, key_map, pinyin, pinyin_map = dict_msg
        device_type = x.device.type
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
            pron_weights = self._remap(weights * mask.reshape(B, T, L), key_map, pinyin_map, generator)
        elif self.use_pallas and not self.training and self.sense_mode == "token":
            # K3 has no backward; it takes k and v in f32, projected in f32
            # under amp too, as the JAX branch projects them
            with f32_island(device_type):
                k = F.linear(keys.float(), w_k)  # [B, T, L, H]
                v = F.linear(values.float(), w_v)
            context, weights, pron_weights = s2pa_fused(
                q.contiguous(), k.contiguous(), v.contiguous(),
                key_map.to(torch.int32).contiguous(), pinyin_map.to(torch.int32).contiguous(),
            )
        else:
            keys = keys.to(q.dtype)
            values = values.to(q.dtype)
            q_e = torch.matmul(q, w_k.to(q.dtype))  # q in bank space
            logits = torch.einsum("btle,bte->btl", keys, q_e).float()
            with f32_island(device_type):
                logits = torch.where(key_map != 0, logits, S2PA_MASK_VALUE)
                weights = torch.softmax(logits, dim=-1)
                weights_d = dropout(weights, self.dropout_rate, self.training, generator)
            ctx_e = torch.einsum("btl,btle->bte", weights_d.to(values.dtype), values)
            context = F.linear(ctx_e, w_v.to(ctx_e.dtype))
            pron_weights = self._remap(weights_d, key_map, pinyin_map, generator)
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
                 dict_embed_dim: int = 768, use_pallas: bool = False, p_dropout: float = 0.0,
                 sense_mode: str = "token", max_senses: int = 10):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.word_emb = nn.Embedding(word_vocab, hidden_channels)
        self.semantic_encoder = RelTransformerLayers(
            hidden_channels, filter_channels, n_heads, n_layers, kernel_size, p_dropout)
        self.s2pa_attention = S2PAAttention(hidden_channels, dict_embed_dim, pinyin_vocab, use_pallas,
                                            p_dropout, sense_mode, max_senses)
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
                 use_pallas: bool = False, dropout: float = 0.0, sense_mode: str = "token",
                 max_senses: int = 10):
        super().__init__()
        self.S2PA_module = S2PATextEncoder(
            word_vocab, hidden_size, hidden_size * 4, num_heads, ffn_kernel_size,
            pinyin_vocab=pinyin_vocab, dict_embed_dim=dict_embed_dim,
            use_pallas=use_pallas, p_dropout=dropout, sense_mode=sense_mode, max_senses=max_senses)

    def forward(self, word_tokens, dict_msg, pron_modified=None, generator=None):
        x, dict_attn, pron_attn, context = self.S2PA_module(word_tokens, dict_msg, pron_modified,
                                                            generator)
        nonpadding = (word_tokens > 0).to(x.dtype)[:, :, None]
        return x * nonpadding, dict_attn, pron_attn, context
