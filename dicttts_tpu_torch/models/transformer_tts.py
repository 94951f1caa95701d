"""TransformerTTS: the autoregressive encoder-decoder acoustic model.

Port of ``dicttts_tpu/models/transformer_tts.py``:
- training is the teacher-forced pass over the whole target (previous
  frames shifted right behind a ``mel_vmin`` frame, a causal mask);
- ``infer`` decodes ``max_decode_len`` frames in a Python loop, where the
  JAX package scans: each layer keeps a K/V cache of its self-attention
  (written at the step's row, attended over the rows so far), the
  cross-attention's K/V are projected once, and the causal conv FFN keeps
  its window of the last k - 1 inputs. The stop head marks the first frame
  whose sigmoid passes 0.5; ``out_mask`` is 0 from there on, and every
  step is decoded (no early exit), as in the JAX package.

Decoder layers are pre-LN: causal self-attention, cross-attention, then
the FFN (a VALID conv-k on the left-padded input, times k^-0.5, tanh GELU,
dropout, linear). The prenet (3 linear layers) keeps its dropout on at
inference and in evaluation, drawn from the ``torch.Generator`` passed in:
its masks cannot match the JAX package's keys, so parity is held at
``prenet_dropout=0``. Feature-last ``[B, T, C]``; parameter names follow
the flax module's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dicttts_tpu_torch.models.fft_blocks import FFTBlocks, position_table
from dicttts_tpu_torch.models.layers import LayerNorm, dropout

NEG_INF = -1e9


class MHA(nn.Module):
    """Multi-head attention with separate projections without bias."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size, bias=False)
        self.k_proj = nn.Linear(hidden_size, hidden_size, bias=False)
        self.v_proj = nn.Linear(hidden_size, hidden_size, bias=False)
        self.out_proj = nn.Linear(hidden_size, hidden_size, bias=False)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor | None = None):
        """Projected q [B, Tq, H] against projected k, v [B, Tk, H]; mask
        broadcastable to [B, heads, Tq, Tk] (True = attend). Returns (out
        [B, Tq, H], weights [B, heads, Tq, Tk])."""
        B, Tq, H = q.shape
        hd = H // self.num_heads
        q = q.reshape(B, Tq, self.num_heads, hd).transpose(1, 2) * hd ** -0.5
        k = k.reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        v = v.reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2))
        if mask is not None:
            logits = logits.masked_fill(~mask, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        out = torch.matmul(w, v).transpose(1, 2).reshape(B, Tq, H)
        return self.out_proj(out), w

    def forward(self, q_in, kv_in, mask=None):
        return self.attend(self.q_proj(q_in), self.k_proj(kv_in), self.v_proj(kv_in), mask)


class TransformerTTSDecoderLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int = 2, kernel_size: int = 9,
                 dropout: float = 0.1):
        super().__init__()
        H = hidden_size
        self.kernel_size, self.dropout = kernel_size, dropout
        self.ln1, self.ln2, self.ln3 = LayerNorm(H), LayerNorm(H), LayerNorm(H)
        self.self_attn = MHA(H, num_heads)
        self.cross_attn = MHA(H, num_heads)
        self.ffn_conv = nn.Conv1d(H, 4 * H, kernel_size)  # VALID, on a left-padded input
        self.ffn_out = nn.Linear(4 * H, H)

    def _drop(self, x, generator):
        return dropout(x, self.dropout, self.training, generator)

    def _ffn(self, h, generator=None):
        """h [B, T + k - 1, H] -> [B, T, H]."""
        f = self.ffn_conv(h.transpose(1, 2)).transpose(1, 2) * self.kernel_size ** -0.5
        return self.ffn_out(self._drop(F.gelu(f, approximate="tanh"), generator))

    def forward(self, x, enc, causal_mask, enc_mask, generator=None):
        h = self.ln1(x)
        h, _ = self.self_attn(h, h, causal_mask)
        x = x + self._drop(h, generator)
        h, attn_w = self.cross_attn(self.ln2(x), enc, enc_mask)
        x = x + self._drop(h, generator)
        h = F.pad(self.ln3(x), (0, 0, self.kernel_size - 1, 0))
        return x + self._drop(self._ffn(h, generator), generator), attn_w

    def project_cross_kv(self, enc):
        return self.cross_attn.k_proj(enc), self.cross_attn.v_proj(enc)

    def step(self, x_t, enc_kv, enc_mask, cache, idx: int):
        """One decode step: x_t [B, H]; enc_kv the projected encoder K/V;
        enc_mask [B, 1, 1, Tk]; cache (k_cache, v_cache [B, T_max, H],
        ffn_buf [B, k - 1, H]), whose caches are written at row ``idx``
        in place. Returns (x_t, ffn_buf)."""
        k_cache, v_cache, ffn_buf = cache
        h = self.ln1(x_t)[:, None]
        k_cache[:, idx] = self.self_attn.k_proj(h)[:, 0]
        v_cache[:, idx] = self.self_attn.v_proj(h)[:, 0]
        a, _ = self.self_attn.attend(self.self_attn.q_proj(h), k_cache[:, :idx + 1],
                                     v_cache[:, :idx + 1])
        x_t = x_t + a[:, 0]
        a, _ = self.cross_attn.attend(self.cross_attn.q_proj(self.ln2(x_t)[:, None]), *enc_kv,
                                      enc_mask)
        x_t = x_t + a[:, 0]
        window = torch.cat([ffn_buf, self.ln3(x_t)[:, None]], dim=1)  # [B, k, H]
        return x_t + self._ffn(window)[:, -1], window[:, 1:]


class TransformerTTS(nn.Module):
    """AR encoder-decoder TTS with a stop head (mel_bins + 1 outputs)."""

    def __init__(self, vocab_size: int, hidden_size: int = 256, enc_layers: int = 4,
                 dec_layers: int = 4, num_heads: int = 2, enc_ffn_kernel_size: int = 9,
                 dec_ffn_kernel_size: int = 9, prenet_hidden_size: int = 256,
                 prenet_dropout: float = 0.5, mel_bins: int = 80, dropout: float = 0.1,
                 mel_vmin: float = -6.0, num_spk: int = 0):
        super().__init__()
        H = hidden_size
        self.hidden_size, self.mel_bins, self.mel_vmin = H, mel_bins, mel_vmin
        self.prenet_dropout, self.dropout, self.num_spk = prenet_dropout, dropout, num_spk
        self.dec_ffn_kernel_size = dec_ffn_kernel_size
        self.embed = nn.Embedding(vocab_size, H)
        nn.init.normal_(self.embed.weight, 0.0, H ** -0.5)
        self.encoder = FFTBlocks(H, enc_layers, enc_ffn_kernel_size, num_heads, dropout)
        self.prenet_fc1 = nn.Linear(mel_bins, prenet_hidden_size)
        self.prenet_fc2 = nn.Linear(prenet_hidden_size, prenet_hidden_size)
        self.prenet_fc3 = nn.Linear(prenet_hidden_size, H, bias=False)
        self.dec_layers = nn.ModuleList(
            TransformerTTSDecoderLayer(H, num_heads, dec_ffn_kernel_size, dropout)
            for _ in range(dec_layers))
        self.dec_ln = LayerNorm(H)
        self.project_out = nn.Linear(H, mel_bins + 1, bias=False)
        self.dec_pos_alpha = nn.Parameter(torch.ones(1))
        if num_spk > 0:
            self.spk_embed = nn.Embedding(num_spk, H)

    def _prenet(self, x, generator, mask=None):
        """The 3-layer prenet, its dropout always on; ``mask`` [B, T, 1]
        (the frames that are not all zero when None)."""
        if mask is None:
            mask = (x.abs().sum(-1, keepdim=True) != 0).to(x.dtype)
        h = dropout(torch.relu(self.prenet_fc1(x)), self.prenet_dropout, True, generator)
        h = dropout(torch.relu(self.prenet_fc2(h)), self.prenet_dropout, True, generator)
        return torch.relu(self.prenet_fc3(h)) * mask

    def encode(self, txt_tokens, spk_ids=None, generator=None):
        nonpadding = (txt_tokens > 0).float()
        x = self.embed(txt_tokens.long()) * math.sqrt(self.hidden_size)
        enc = self.encoder(x, nonpadding, generator)
        if self.num_spk > 0 and spk_ids is not None:
            enc = enc + self.spk_embed(spk_ids.long())[:, None, :]
        return enc, nonpadding

    def forward(self, txt_tokens: torch.Tensor, tgt_mels: torch.Tensor,
                spk_ids: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict:
        """Teacher-forced: txt_tokens [B, T_txt], tgt_mels [B, T, M] ->
        mel_out [B, T, M], stop_logits [B, T], attn (per layer [B, heads,
        T, T_txt])."""
        enc, src_nonpad = self.encode(txt_tokens, spk_ids, generator)
        prev = F.pad(tgt_mels[:, :-1], (0, 0, 1, 0), value=self.mel_vmin)
        tgt_nonpad = (tgt_mels.abs().sum(-1) != 0).float()
        T = prev.shape[1]
        x = self._prenet(prev, generator)
        pos = position_table(T, self.hidden_size, prev.device)
        x = x + self.dec_pos_alpha * pos[None] * tgt_nonpad[:, :, None]
        x = dropout(x, self.dropout, self.training, generator)
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device=prev.device))[None, None]
        causal = causal & (tgt_nonpad[:, None, None, :] > 0)
        enc_mask = src_nonpad[:, None, None, :] > 0
        attn = []
        for layer in self.dec_layers:
            x, w = layer(x, enc, causal, enc_mask, generator)
            attn.append(w)
        y = self.project_out(self.dec_ln(x))
        return {"mel_out": y[..., :self.mel_bins], "stop_logits": y[..., -1], "attn": attn}

    @torch.no_grad()
    def infer(self, txt_tokens: torch.Tensor, max_decode_len: int,
              spk_ids: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> dict:
        """Decode ``max_decode_len`` frames (``estimate_decode_length`` is a
        sensible choice). Returns mel_out (zero from the first stop on),
        mel_raw (unmasked), stop_logits and out_mask [B, T] (1 before the
        first stop)."""
        B, H, M = txt_tokens.shape[0], self.hidden_size, self.mel_bins
        dev = txt_tokens.device
        enc, src_nonpad = self.encode(txt_tokens, spk_ids)
        enc_mask = (src_nonpad > 0)[:, None, None, :]
        enc_kvs = [layer.project_cross_kv(enc) for layer in self.dec_layers]
        pos = position_table(max_decode_len, H, dev)
        k = self.dec_ffn_kernel_size
        caches = [[torch.zeros(B, max_decode_len, H, device=dev),
                   torch.zeros(B, max_decode_len, H, device=dev),
                   torch.zeros(B, k - 1, H, device=dev)] for _ in self.dec_layers]
        ones = torch.ones(B, 1, device=dev)
        prev = torch.full((B, M), self.mel_vmin, device=dev)
        hit = torch.zeros(B, dtype=torch.bool, device=dev)
        mels, stops, eos = [], [], []
        for idx in range(max_decode_len):
            x_t = self._prenet(prev, generator, ones) + self.dec_pos_alpha * pos[idx]
            for layer, enc_kv, cache in zip(self.dec_layers, enc_kvs, caches):
                x_t, cache[2] = layer.step(x_t, enc_kv, enc_mask, cache, idx)
            y = self.project_out(self.dec_ln(x_t))
            prev, stop_t = y[:, :M], y[:, M]
            hit = hit | (torch.sigmoid(stop_t) > 0.5)
            mels.append(prev)
            stops.append(stop_t)
            eos.append(hit)
        mels = torch.stack(mels, 1)
        out_mask = (~torch.stack(eos, 1)).float()
        return {"mel_out": mels * out_mask[:, :, None], "mel_raw": mels,
                "stop_logits": torch.stack(stops, 1), "out_mask": out_mask}

    @staticmethod
    def estimate_decode_length(input_length: int) -> int:
        return input_length * 8 + 100
