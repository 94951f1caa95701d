"""Dict-TTS acoustic model: DictEncoder (S2PA) -> word durations -> word
states gathered to frames -> FVAE.

Port of ``dicttts_tpu/models/dict_tts.py`` (``DictTTS``). With
``num_spk`` > 0 a learned speaker embedding (``spk_embed_proj``) of each
row's ``spk_ids`` is added to the encoder output. Training: ``mel2word`` and the target mels are given; the FVAE encodes the
target and the result carries ``kl``. Inference: durations are predicted
and length-regulated to a static ``max_frames``, and the FVAE samples its
prior. Defaults are the production recipe (``configs/tts/dict_tts.yaml``
on ``ps_adv.yaml`` / ``ps_flow.yaml``).
"""

from __future__ import annotations

import torch
from torch import nn

from dicttts_tpu_torch.models.dict_encoder import DictEncoder, DictMsg
from dicttts_tpu_torch.models.duration import DurationPredictor, out2dur
from dicttts_tpu_torch.models.fvae import FVAE
from dicttts_tpu_torch.ops.seq import gather_expand, length_regulate, pad_frames_multiple


class DictTTS(nn.Module):
    def __init__(self, word_vocab: int = 8000, hidden_size: int = 192, num_heads: int = 2,
                 enc_ffn_kernel_size: int = 5, pinyin_vocab: int = 185, dict_embed_dim: int = 768,
                 dur_predictor_layers: int = 3, dur_predictor_kernel: int = 5,
                 dur_predictor_chans: int = 128, frames_multiple: int = 4, out_dims: int = 80,
                 dropout: float = 0.1, predictor_dropout: float = 0.2, predictor_grad: float = 0.1,
                 latent_size: int = 16, fvae_enc_dec_hidden: int = 192, fvae_kernel_size: int = 5,
                 fvae_enc_n_layers: int = 8, fvae_dec_n_layers: int = 4, use_prior_flow: bool = True,
                 prior_flow_hidden: int = 64, prior_flow_kernel_size: int = 3,
                 prior_flow_n_blocks: int = 4, fvae_strides: int = 4, num_spk: int = 0,
                 use_pallas_s2pa: bool = False, s2pa_sense_mode: str = "token",
                 s2pa_max_senses: int = 10):
        super().__init__()
        self.frames_multiple = frames_multiple
        self.predictor_grad = predictor_grad
        self.num_spk = num_spk
        self.dict_encoder = DictEncoder(word_vocab, hidden_size, num_heads, enc_ffn_kernel_size,
                                        pinyin_vocab, dict_embed_dim, use_pallas_s2pa, dropout,
                                        s2pa_sense_mode, s2pa_max_senses)
        self.dur_predictor = DurationPredictor(hidden_size, dur_predictor_chans,
                                               dur_predictor_layers, dur_predictor_kernel,
                                               predictor_dropout)
        self.fvae = FVAE(out_dims, fvae_enc_dec_hidden, latent_size, fvae_kernel_size,
                         fvae_enc_n_layers, fvae_dec_n_layers, hidden_size, (fvae_strides,),
                         prior_flow_hidden, prior_flow_kernel_size, prior_flow_n_blocks,
                         use_prior_flow)
        if num_spk > 0:
            self.spk_embed_proj = nn.Embedding(num_spk, hidden_size)

    def forward(self, word_tokens: torch.Tensor, dict_msg: DictMsg,
                pron_modified: torch.Tensor | None = None, *, mel2word: torch.Tensor | None = None,
                spk_ids: torch.Tensor | None = None,
                tgt_mels: torch.Tensor | None = None, max_frames: int | None = None,
                noise: torch.Tensor | None = None, noise_scale: float = 1.0,
                generator: torch.Generator | None = None) -> dict:
        """word_tokens [B, T_w] -> dict with mel_out [B, T_mel, out_dims],
        mel2word [B, T_mel] int32, dur, dict_attn, pron_attn, z_p, x_mask
        and decoder_inp. ``spk_ids`` [B]: the speakers, with ``num_spk`` > 0.

        Training (``tgt_mels`` [B, T_mel, out_dims] given, with
        ``mel2word``): the FVAE encodes the target, ``noise`` is its
        posterior eps [B, T_mel / 4, latent]; adds kl, m_q and logs_q.
        Inference: ``mel2word`` is predicted up to ``max_frames`` unless
        given, and ``noise`` is the prior sample. ``generator`` draws the
        noise that is not given and, in training mode, the dropout masks."""
        nonpadding = (word_tokens > 0).float()
        x, dict_attn, pron_attn, _ = self.dict_encoder(word_tokens, dict_msg, pron_modified,
                                                       generator)
        if self.num_spk > 0 and spk_ids is not None:
            x = x + self.spk_embed_proj(spk_ids.long())[:, None, :]
        # straight-through mix: the value of x, 0.1 of its gradient
        dur_input = x.detach() + self.predictor_grad * (x - x.detach())
        dur = self.dur_predictor(dur_input * nonpadding[:, :, None], nonpadding, generator)
        if mel2word is None:
            if max_frames is None:
                raise ValueError("predicting durations needs a static max_frames")
            dur_frames = out2dur(dur) * nonpadding.to(torch.int32)
            mel2word = length_regulate(dur_frames, max_frames, nonpadding)
            mel2word = pad_frames_multiple(mel2word, self.frames_multiple)
        x_mask = (mel2word > 0).float()[:, :, None]
        g = gather_expand(x, mel2word) * x_mask.to(x.dtype)
        ret = {"dict_attn": dict_attn, "pron_attn": pron_attn, "dur": dur, "mel2word": mel2word,
               "x_mask": x_mask, "decoder_inp": g}
        if tgt_mels is None:
            mel_out, ret["z_p"] = self.fvae.infer(g, x_mask, noise, noise_scale, generator)
        else:
            mel_out, ret["kl"], ret["z_p"], ret["m_q"], ret["logs_q"] = self.fvae(
                tgt_mels, x_mask, g, noise, generator, noise_scale)
        ret["mel_out"] = mel_out.float() * x_mask
        return ret
