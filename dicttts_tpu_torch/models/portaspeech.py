"""PortaSpeech acoustic model, with the optional post-net Glow.

Port of ``dicttts_tpu/models/portaspeech.py`` (``PortaSpeech``): phone ids
-> rel-window transformer encoder (with its ConvReluNorm prenet) -> word
states pooled by ``ph2word`` -> FFT word encoder -> phone-level durations
(softplus head) summed to words -> length regulation (inference) ->
single-head word-to-frame attention with sinusoidal intra-word positions
and a hard word mask (-1e9) -> FVAE decoder; with ``use_post_glow`` the
post-net Glow is trained by the NLL of the target mels (``postflow``) and
at inference inverts scaled noise into the output mels.

As in the JAX package:
- frames of no word (mel2word 0) attend to the padding phones of their row
  (both have word id 0), or uniformly when the row has none; ``attn`` is
  returned as computed;
- at inference the Glow is inverted under an all-ones mask, not the frame
  mask, so its kernel-3 convolutions carry the noise of padding frames into
  the last real frames; only the result is masked.

Under amp the word pooling, the word-to-frame attention and the duration
predictor run in f32 (the JAX modules and one-hot sums see f32 inputs, or
have no compute dtype, and promote to f32), and so do
the FVAE's KL and prior flow and the whole Glow. Noise: ``noise`` is the
FVAE's posterior eps (training) or prior sample (inference) [B, T / 4,
latent], ``post_noise`` the Glow's sample [B, T, out_dims]; either is
drawn from ``generator`` when not given.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dicttts_tpu_torch.models.duration import DurationPredictor, out2dur
from dicttts_tpu_torch.models.fft_blocks import FFTBlocks, position_table
from dicttts_tpu_torch.models.fvae import FVAE
from dicttts_tpu_torch.models.layers import RelTransformerEncoder
from dicttts_tpu_torch.models.post_glow import Glow
from dicttts_tpu_torch.ops.amp import f32_island
from dicttts_tpu_torch.ops.seq import (build_word_mask, gather_expand, group_hidden_by_segs,
                                       intra_word_positions, length_regulate, pad_frames_multiple,
                                       scatter_sum_by_segs)

WORD_MASK_VALUE = -1e9


def sin_pos_embed(positions: torch.Tensor, dim: int, max_pos: int = 2048) -> torch.Tensor:
    """Fractional intra-word positions [B, T] rounded onto a sinusoid table
    (32 rows per unit of position) -> [B, T, dim]."""
    table = position_table(max_pos, dim, positions.device, offset=0)
    idx = torch.clamp(torch.round(positions * 32).long(), 0, max_pos - 1)
    return table[idx]


class PortaSpeech(nn.Module):
    def __init__(self, n_vocab: int, hidden_size: int = 192, num_heads: int = 2,
                 enc_layers: int = 4, word_enc_layers: int = 4, enc_ffn_kernel_size: int = 5,
                 dropout: float = 0.1, dur_predictor_layers: int = 3, dur_predictor_kernel: int = 5,
                 predictor_dropout: float = 0.2, predictor_grad: float = 0.1,
                 frames_multiple: int = 4, out_dims: int = 80, latent_size: int = 16,
                 fvae_enc_dec_hidden: int = 192, fvae_kernel_size: int = 5,
                 fvae_enc_n_layers: int = 8, fvae_dec_n_layers: int = 4,
                 use_prior_flow: bool = True, prior_flow_hidden: int = 64,
                 prior_flow_kernel_size: int = 3, prior_flow_n_blocks: int = 4, num_spk: int = 0,
                 use_post_glow: bool = False, post_glow_hidden: int = 192,
                 post_glow_kernel_size: int = 3, post_glow_n_blocks: int = 12,
                 post_glow_n_block_layers: int = 3, share_wn_layers: int = 4,
                 sigmoid_scale: bool = False, use_txt_cond: bool = True,
                 detach_postflow_input: bool = True, infer_post_glow: bool = True,
                 post_noise_scale: float = 0.8):
        super().__init__()
        H = hidden_size
        self.hidden_size = H
        self.out_dims = out_dims
        self.frames_multiple = frames_multiple
        self.predictor_grad = predictor_grad
        self.num_spk = num_spk
        self.use_txt_cond = use_txt_cond
        self.detach_postflow_input = detach_postflow_input
        self.infer_post_glow = infer_post_glow
        self.post_noise_scale = post_noise_scale
        self.ph_encoder = RelTransformerEncoder(n_vocab, H, 4 * H, num_heads, enc_layers,
                                                enc_ffn_kernel_size, dropout, window_size=4)
        self.word_encoder = FFTBlocks(H, word_enc_layers, ffn_kernel_size=1, n_heads=num_heads,
                                      dropout=dropout)
        self.enc_pos_proj = nn.Linear(2 * H, H, bias=False)
        self.dec_query_proj = nn.Linear(2 * H, H, bias=False)
        self.dec_res_proj = nn.Linear(2 * H, H, bias=False)
        self.attn_out = nn.Linear(H, H, bias=False)
        self.dur_predictor = DurationPredictor(H, 128, dur_predictor_layers, dur_predictor_kernel,
                                               predictor_dropout)
        self.fvae = FVAE(out_dims, fvae_enc_dec_hidden, latent_size, fvae_kernel_size,
                         fvae_enc_n_layers, fvae_dec_n_layers, H, (4,), prior_flow_hidden,
                         prior_flow_kernel_size, prior_flow_n_blocks, use_prior_flow)
        if num_spk > 0:
            self.spk_embed_proj = nn.Embedding(num_spk, H)
        self.post_flow = (Glow(out_dims, post_glow_hidden, post_glow_kernel_size,
                               post_glow_n_blocks, post_glow_n_block_layers, 4, 2,
                               out_dims + (H if use_txt_cond else 0), share_wn_layers,
                               sigmoid_scale) if use_post_glow else None)

    def _word_frame_attention(self, ph_enc, word_enc, ph2word, mel2word, word2word):
        """Single-head attention of each frame over its word's phones, in f32."""
        H = self.hidden_size
        with f32_island(ph_enc.device.type):
            ph_enc, word_enc = ph_enc.float(), word_enc.float()
            enc_pos = sin_pos_embed(intra_word_positions(word2word, ph2word), H)  # [B, T_ph, H]
            dec_pos = sin_pos_embed(intra_word_positions(word2word, mel2word), H)  # [B, T_mel, H]
            ph_kv = self.enc_pos_proj(torch.cat([ph_enc, enc_pos], -1))
            q_in = torch.cat([gather_expand(word_enc, mel2word), dec_pos], -1)
            q = self.dec_query_proj(q_in)
            x_res = self.dec_res_proj(q_in)
            word_mask = build_word_mask(mel2word, ph2word)  # [B, T_mel, T_ph]
            scores = torch.matmul(q, ph_kv.transpose(1, 2)) / math.sqrt(float(H))
            scores = scores.masked_fill(word_mask == 0, WORD_MASK_VALUE)
            weights = torch.softmax(scores, dim=-1)
            x = self.attn_out(torch.matmul(weights, ph_kv)) + x_res
        return x, weights

    def forward(self, txt_tokens: torch.Tensor, ph2word: torch.Tensor, word_len: int, *,
                mel2word: torch.Tensor | None = None, spk_ids: torch.Tensor | None = None,
                tgt_mels: torch.Tensor | None = None, infer: bool = False,
                max_frames: int | None = None, noise: torch.Tensor | None = None,
                post_noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict:
        """txt_tokens [B, T_ph] phone ids, ph2word [B, T_ph] 1-based word ids,
        word_len the static word count -> dict with mel_out [B, T_mel,
        out_dims], mel2word, dur [B, word_len], attn [B, T_mel, T_ph],
        decoder_inp, z_p; training (``infer`` False, ``tgt_mels`` and
        ``mel2word`` given) adds kl, m_q, logs_q and, with the Glow,
        z_pf, ldj_pf and postflow. At inference ``mel2word`` is predicted
        up to ``max_frames`` unless given."""
        src_nonpadding = (txt_tokens > 0).float()[:, :, None]
        ph_enc = self.ph_encoder(txt_tokens, generator) * src_nonpadding
        if self.num_spk > 0 and spk_ids is not None:
            ph_enc = ph_enc + self.spk_embed_proj(spk_ids.long())[:, None, :]
        with f32_island(ph_enc.device.type):  # f32 sums, as the JAX package's one-hot einsums
            word_states = group_hidden_by_segs(ph_enc.float(), ph2word, word_len)
        word_nonpad = word_states.abs().sum(dim=-1) > 0
        word_enc = self.word_encoder(word_states, word_nonpad, generator)
        # straight-through mix: the value of ph_enc, predictor_grad of its gradient
        dur_inp = ph_enc.detach() + self.predictor_grad * (ph_enc - ph_enc.detach())
        dur_ph = self.dur_predictor(dur_inp, src_nonpadding[:, :, 0], generator)
        with f32_island(dur_ph.device.type):
            dur = scatter_sum_by_segs(dur_ph.float(), ph2word, word_len)
        ret = {"dur": dur}
        if mel2word is None:
            if max_frames is None:
                raise ValueError("predicting durations needs a static max_frames")
            dur_frames = out2dur(dur) * word_nonpad.to(torch.int32)
            mel2word = length_regulate(dur_frames, max_frames, word_nonpad)
            mel2word = pad_frames_multiple(mel2word, self.frames_multiple)
        ret["mel2word"] = mel2word
        tgt_nonpadding = (mel2word > 0).float()[:, :, None]
        word2word = torch.arange(1, word_len + 1, device=txt_tokens.device).expand(
            txt_tokens.shape[0], word_len)
        x, ret["attn"] = self._word_frame_attention(ph_enc, word_enc, ph2word, mel2word, word2word)
        if self.num_spk > 0 and spk_ids is not None:
            x = x + self.spk_embed_proj(spk_ids.long())[:, None, :]
        x = x * tgt_nonpadding
        ret["decoder_inp"] = x
        if infer:
            mel_out, ret["z_p"] = self.fvae.infer(x, tgt_nonpadding, noise, 1.0, generator)
        else:
            mel_out, ret["kl"], ret["z_p"], ret["m_q"], ret["logs_q"] = self.fvae(
                tgt_mels, tgt_nonpadding, x, noise, generator)
        ret["mel_out"] = ret["mel_out_fvae"] = mel_out.float() * tgt_nonpadding
        if self.post_flow is not None:
            self._run_post_glow(ret, tgt_nonpadding, tgt_mels, infer, post_noise, generator)
        return ret

    def _run_post_glow(self, ret, tgt_nonpadding, tgt_mels, infer, post_noise, generator):
        """Condition on the FVAE output (and the decoder input); training:
        the NLL of the target mels per frame and bin; inference: invert
        scaled noise under an all-ones mask."""
        g = ret["mel_out_fvae"]
        if self.use_txt_cond:
            g = torch.cat([g, ret["decoder_inp"].float()], dim=-1)
        if self.detach_postflow_input:
            g = g.detach()
        if not infer:
            z, ldj = self.post_flow(tgt_mels, tgt_nonpadding, g)
            frames = torch.clamp(tgt_nonpadding.sum(dim=(1, 2)), min=1.0)
            ldj = ldj / frames / self.out_dims
            ret["z_pf"], ret["ldj_pf"] = z, ldj
            ret["postflow"] = (0.5 * torch.mean(torch.square(z)) + 0.5 * math.log(2 * math.pi)
                               - torch.mean(ldj))
        elif self.infer_post_glow:
            shape = ret["mel_out"].shape
            if post_noise is None:
                post_noise = torch.randn(shape, generator=generator, device=g.device)
            z = post_noise.float() * self.post_noise_scale
            mel_post, _ = self.post_flow(z, torch.ones_like(ret["mel_out"][..., :1]), g,
                                         reverse=True)
            ret["mel_out"] = mel_post * tgt_nonpadding
