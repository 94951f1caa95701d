"""FastSpeech2 acoustic model with its encoder and decoder registries.

Port of ``dicttts_tpu/models/fastspeech2.py``: token ids -> encoder
(``FS_ENCODERS``: 'fft', 'rel_fft', 'conformer', 'tacotron', 'tacotron2')
-> phone-level duration predictor (plain linear head) -> length
regulation (at inference, up to a static ``max_frames``) -> the optional
pitch path (a conv predictor of (f0, uv) per frame; the ground truth in
training, the prediction at inference; its f0 in Hz bucketed on the mel
scale into an embedding) and energy path -> decoder (``FS_DECODERS``:
'fft', 'conv', 'wn', 'conformer', 'rnn') -> linear mel head, masked.
The predictors see their input's value but ``predictor_grad`` of its
gradient (``x.detach() + g * (x - x.detach())``). A speaker embedding
and a reference-mel encoder (``RefEncoder``) add to every predictor's
input and to the decoder's.

Under amp the encoders and decoders whose JAX modules take the activation
dtype (fft, rel_fft, conformer, wn) run under the caller's autocast; the
others (tacotron, tacotron2, conv, rnn), the predictors, the embeddings'
sums and the mel head run in f32 with autocast off, as the JAX modules
without a compute dtype promote to f32.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from dicttts_tpu_torch.models.conformer import ConformerLayers
from dicttts_tpu_torch.models.duration import DurationPredictor, out2dur
from dicttts_tpu_torch.models.fft_blocks import FFTBlocks
from dicttts_tpu_torch.models.layers import LayerNorm, RelTransformerEncoder, conv1d_tc, dropout
from dicttts_tpu_torch.models.tacotron import DecoderRNN, Tacotron2Encoder, TacotronEncoder
from dicttts_tpu_torch.models.wavenet import WN
from dicttts_tpu_torch.ops.amp import f32_island
from dicttts_tpu_torch.ops.pitch import denorm_f0, f0_to_coarse
from dicttts_tpu_torch.ops.seq import gather_expand, length_regulate

FS_ENCODERS: dict[str, Callable] = {}
FS_DECODERS: dict[str, Callable] = {}
# the entries whose JAX modules compute in the amp activation dtype
AMP_ENCODERS = frozenset({"fft", "rel_fft", "conformer"})
AMP_DECODERS = frozenset({"fft", "wn", "conformer"})


def register_encoder(name):
    def deco(fn):
        FS_ENCODERS[name] = fn
        return fn

    return deco


def register_decoder(name):
    def deco(fn):
        FS_DECODERS[name] = fn
        return fn

    return deco


class TokenEncoder(nn.Module):
    """Token embedding scaled by sqrt(H) (pad id 0) into a stack that takes
    (x, nonpadding, generator): the FFT and conformer encoders."""

    def __init__(self, n_vocab: int, hidden_size: int, layers: nn.Module):
        super().__init__()
        self.hidden_size = hidden_size
        self.embed = nn.Embedding(n_vocab, hidden_size)
        nn.init.normal_(self.embed.weight, 0.0, hidden_size ** -0.5)
        self.layers = layers

    def forward(self, tokens, generator=None):
        x = self.embed(tokens.long()) * math.sqrt(self.hidden_size)
        return self.layers(x, (tokens > 0).to(x.dtype), generator)


@register_encoder("fft")
def _fft_encoder(cfg):
    return TokenEncoder(cfg["n_vocab"], cfg["hidden_size"], FFTBlocks(
        cfg["hidden_size"], cfg["enc_layers"], cfg["enc_ffn_kernel_size"], cfg["num_heads"],
        cfg["dropout"]))


@register_encoder("conformer")
def _conformer_encoder(cfg):
    return TokenEncoder(cfg["n_vocab"], cfg["hidden_size"], ConformerLayers(
        cfg["hidden_size"], cfg["enc_layers"], cfg["num_heads"], dropout=cfg["dropout"]))


@register_encoder("tacotron")
def _tacotron_encoder(cfg):
    return TacotronEncoder(cfg["n_vocab"], cfg["hidden_size"], dropout=cfg["dropout"])


@register_encoder("tacotron2")
def _tacotron2_encoder(cfg):
    return Tacotron2Encoder(cfg["n_vocab"], cfg["hidden_size"])


@register_encoder("rel_fft")
def _rel_fft_encoder(cfg):
    H = cfg["hidden_size"]
    return RelTransformerEncoder(cfg["n_vocab"], H, 4 * H, cfg["num_heads"], cfg["enc_layers"],
                                 cfg["enc_ffn_kernel_size"], cfg["dropout"])


@register_decoder("fft")
def _fft_decoder(cfg):
    return FFTBlocks(cfg["hidden_size"], cfg["dec_layers"], cfg["dec_ffn_kernel_size"],
                     cfg["num_heads"], cfg["dropout"])


@register_decoder("conformer")
def _conformer_decoder(cfg):
    return ConformerLayers(cfg["hidden_size"], cfg["dec_layers"], cfg["num_heads"],
                           dropout=cfg["dropout"])


@register_decoder("rnn")
def _rnn_decoder(cfg):
    return DecoderRNN(cfg["hidden_size"])


class ConvDecoder(nn.Module):
    """n_layers of [conv-k "SAME" on the masked input, relu, LayerNorm,
    dropout, residual], masked."""

    def __init__(self, hidden_size: int, n_layers: int, kernel_size: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.convs = nn.ModuleList(nn.Conv1d(hidden_size, hidden_size, kernel_size, padding="same")
                                   for _ in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(hidden_size) for _ in range(n_layers))

    def forward(self, x, nonpadding, generator=None):
        mask = nonpadding[:, :, None].to(x.dtype)
        for conv, norm in zip(self.convs, self.norms):
            h = norm(torch.relu(conv1d_tc(x * mask, conv)))
            x = (dropout(h, self.dropout, self.training, generator) + x) * mask
        return x


@register_decoder("conv")
def _conv_decoder(cfg):
    return ConvDecoder(cfg["hidden_size"], cfg["dec_layers"], cfg["dec_ffn_kernel_size"],
                       cfg["dropout"])


class WNDecoder(nn.Module):
    """The non-causal WaveNet stack (kernel 3, dilations 2^i) over the frames."""

    def __init__(self, hidden_size: int, n_layers: int):
        super().__init__()
        self.wn = WN(hidden_size, 3, 2, n_layers)

    def forward(self, x, nonpadding, generator=None):
        return self.wn(x, nonpadding[:, :, None])


@register_decoder("wn")
def _wn_decoder(cfg):
    return WNDecoder(cfg["hidden_size"], cfg["dec_layers"])


class PitchPredictor(nn.Module):
    """n_layers of [conv-k "SAME", relu, LayerNorm (eps 1e-5), dropout],
    then a linear head: [B, T, C] -> [B, T, odim] ((f0, uv) by default).
    Its input is not masked inside."""

    def __init__(self, in_channels: int, n_chans: int = 384, n_layers: int = 5,
                 kernel_size: int = 5, dropout_rate: float = 0.1, odim: int = 2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.convs = nn.ModuleList(nn.Conv1d(in_channels if i == 0 else n_chans, n_chans,
                                             kernel_size, padding="same") for i in range(n_layers))
        self.norms = nn.ModuleList(LayerNorm(n_chans, eps=1e-5) for _ in range(n_layers))
        self.out = nn.Linear(n_chans, odim)

    def forward(self, x, generator=None):
        for conv, norm in zip(self.convs, self.norms):
            x = norm(torch.relu(conv1d_tc(x, conv)))
            x = dropout(x, self.dropout_rate, self.training, generator)
        return self.out(x)


class EnergyPredictor(PitchPredictor):
    """A one-output ``PitchPredictor``: [B, T, C] -> [B, T] energy."""

    def __init__(self, in_channels: int, n_chans: int = 384, n_layers: int = 5,
                 kernel_size: int = 5, dropout_rate: float = 0.1):
        super().__init__(in_channels, n_chans, n_layers, kernel_size, dropout_rate, odim=1)

    def forward(self, x, generator=None):
        return super().forward(x, generator)[..., 0]


def energy_to_coarse(energy: torch.Tensor, bins: int = 256, max_energy: float = 4.0) -> torch.Tensor:
    """Frame energy -> int32 bucket ids 1..bins-1 (0 where the energy is not
    positive)."""
    ids = torch.clamp(energy / max_energy * (bins - 2), 0, bins - 2).to(torch.int32) + 1
    return torch.where(energy > 0, ids, torch.zeros_like(ids))


def mel_energy(mel: torch.Tensor) -> torch.Tensor:
    """[B, T, C] log10-mel -> [B, T] frame energy (RMS of the linear mel)."""
    return torch.sqrt(torch.mean(torch.square(torch.pow(10.0, mel)), dim=-1))


class RefEncoder(nn.Module):
    """Reference-mel utterance encoder: strided convs (each padded kernel //
    2 on both sides) with relu, LayerNorm and dropout, the mean over all
    frames, a linear projection: [B, T, C_mel] -> [B, out_channels].
    ``hidden_stride_kernel``: "filters,stride,kernel" strings, filters 0
    meaning out_channels."""

    def __init__(self, in_channels: int = 80, out_channels: int = 192,
                 hidden_stride_kernel: tuple = ("0,3,5", "0,3,5", "0,2,5", "0,2,5", "0,2,5"),
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        for fsk in hidden_stride_kernel:
            filters, stride, kernel = (int(v) for v in fsk.split(","))
            filters = filters or out_channels
            self.convs.append(nn.Conv1d(in_channels, filters, kernel, stride=stride,
                                        padding=kernel // 2))
            self.norms.append(LayerNorm(filters))
            in_channels = filters
        self.proj = nn.Linear(in_channels, out_channels)

    def forward(self, mel, generator=None):
        x = mel
        for conv, norm in zip(self.convs, self.norms):
            x = norm(torch.relu(conv1d_tc(x, conv)))
            x = dropout(x, self.dropout, self.training, generator)
        return self.proj(x.mean(dim=1))


def straight_through(x: torch.Tensor, g: float) -> torch.Tensor:
    """x's value, g times its gradient."""
    return x.detach() + g * (x - x.detach())


class FastSpeech2(nn.Module):
    def __init__(self, n_vocab: int, hidden_size: int = 256, out_dims: int = 80,
                 encoder_type: str = "fft", decoder_type: str = "fft", enc_layers: int = 4,
                 dec_layers: int = 4, enc_ffn_kernel_size: int = 9, dec_ffn_kernel_size: int = 9,
                 num_heads: int = 2, dropout: float = 0.1, dur_predictor_layers: int = 2,
                 dur_predictor_kernel: int = 3, predictor_hidden: int = -1,
                 predictor_dropout: float = 0.5, predictor_kernel: int = 5,
                 predictor_grad: float = 0.1, use_pitch_embed: bool = True, use_uv: bool = True,
                 pitch_norm: str = "log", use_energy_embed: bool = False, use_ref_enc: bool = False,
                 num_spk: int = 0):
        super().__init__()
        H = hidden_size
        cfg = {"n_vocab": n_vocab, "hidden_size": H, "enc_layers": enc_layers,
               "dec_layers": dec_layers, "enc_ffn_kernel_size": enc_ffn_kernel_size,
               "dec_ffn_kernel_size": dec_ffn_kernel_size, "num_heads": num_heads,
               "dropout": dropout}
        self.encoder_type, self.decoder_type = encoder_type, decoder_type
        self.predictor_grad = predictor_grad
        self.use_pitch_embed, self.use_uv, self.pitch_norm = use_pitch_embed, use_uv, pitch_norm
        self.use_energy_embed, self.use_ref_enc, self.num_spk = use_energy_embed, use_ref_enc, num_spk
        self.encoder = FS_ENCODERS[encoder_type](cfg)
        self.decoder = FS_DECODERS[decoder_type](cfg)
        self.mel_head = nn.Linear(H, out_dims)
        ph = predictor_hidden if predictor_hidden > 0 else H
        self.dur_predictor = DurationPredictor(H, ph, dur_predictor_layers, dur_predictor_kernel,
                                               predictor_dropout, softplus_out=False)
        if use_pitch_embed:
            self.pitch_embed = nn.Embedding(300, H)
            self.pitch_predictor = PitchPredictor(H, ph, kernel_size=predictor_kernel)
        if use_energy_embed:
            self.energy_embed = nn.Embedding(256, H)
            self.energy_predictor = EnergyPredictor(H, ph, kernel_size=predictor_kernel)
        if use_ref_enc:
            self.ref_encoder = RefEncoder(out_dims, H, dropout=dropout)
        if num_spk > 0:
            self.spk_embed_proj = nn.Embedding(num_spk, H)

    def forward(self, txt_tokens: torch.Tensor, mel2ph: torch.Tensor | None = None, *,
                spk_ids: torch.Tensor | None = None, f0: torch.Tensor | None = None,
                uv: torch.Tensor | None = None, energy: torch.Tensor | None = None,
                ref_mels: torch.Tensor | None = None, max_frames: int | None = None,
                generator: torch.Generator | None = None) -> dict:
        """txt_tokens [B, T_txt] (0 = pad); mel2ph [B, T_mel] (1-based, 0 =
        pad frame), predicted up to ``max_frames`` when None; f0, uv,
        energy [B, T_mel] (normalized f0), the predictions where None;
        ref_mels [B, T_ref, C] for the RefEncoder. Returns dur, mel2ph,
        pitch_pred, f0_denorm, energy_pred (with their paths),
        decoder_inp and mel_out [B, T_mel, out_dims], in f32."""
        device_type = txt_tokens.device.type
        if self.encoder_type in AMP_ENCODERS:
            enc = self.encoder(txt_tokens, generator)
        else:
            with f32_island(device_type):
                enc = self.encoder(txt_tokens, generator)
        with f32_island(device_type):
            ret, decoder_inp = self._variance(enc.float(), txt_tokens, mel2ph, spk_ids, f0, uv,
                                              energy, ref_mels, max_frames, generator)
            tgt_nonpadding = (ret["mel2ph"] > 0).float()[:, :, None]
        if self.decoder_type in AMP_DECODERS:
            x = self.decoder(decoder_inp, tgt_nonpadding[:, :, 0], generator)
        else:
            with f32_island(device_type):
                x = self.decoder(decoder_inp, tgt_nonpadding[:, :, 0], generator)
        with f32_island(device_type):
            ret["mel_out"] = self.mel_head(x.float()) * tgt_nonpadding
        return ret

    def _variance(self, enc, txt_tokens, mel2ph, spk_ids, f0, uv, energy, ref_mels, max_frames,
                  generator):
        """Speaker, duration, length regulation, pitch and energy: (ret,
        decoder_inp)."""
        g = self.predictor_grad
        src_nonpadding = (txt_tokens > 0).float()[:, :, None]
        spk = 0.0
        if self.num_spk > 0 and spk_ids is not None:
            spk = self.spk_embed_proj(spk_ids.long())[:, None, :]
        if self.use_ref_enc and ref_mels is not None:
            spk = spk + self.ref_encoder(ref_mels.float(), generator)[:, None, :]
        dur_inp = straight_through((enc + spk) * src_nonpadding, g)
        ret = {"dur": self.dur_predictor(dur_inp, src_nonpadding[:, :, 0], generator)}
        if mel2ph is None:
            if max_frames is None:
                raise ValueError("predicting durations needs a static max_frames")
            nonpad = txt_tokens > 0
            mel2ph = length_regulate(out2dur(ret["dur"]) * nonpad.to(torch.int32), max_frames, nonpad)
        ret["mel2ph"] = mel2ph
        tgt_nonpadding = (mel2ph > 0).float()[:, :, None]
        decoder_inp = gather_expand(enc, mel2ph)
        if self.use_pitch_embed:
            pitch_pred = self.pitch_predictor(
                straight_through((decoder_inp + spk) * tgt_nonpadding, g), generator)
            ret["pitch_pred"] = pitch_pred
            if f0 is None:
                f0 = pitch_pred[:, :, 0]
                uv = (pitch_pred[:, :, 1] > 0).float() if self.use_uv else None
            ret["f0_denorm"] = f0_denorm = denorm_f0(f0.float(), uv if self.use_uv else None,
                                                     self.pitch_norm, pitch_padding=mel2ph == 0)
            decoder_inp = decoder_inp + self.pitch_embed(f0_to_coarse(f0_denorm).long())
        if self.use_energy_embed:
            energy_pred = self.energy_predictor(
                straight_through((decoder_inp + spk) * tgt_nonpadding, g), generator)
            ret["energy_pred"] = energy_pred
            if energy is None:
                energy = energy_pred
            decoder_inp = decoder_inp + self.energy_embed(energy_to_coarse(energy.float()).long())
        decoder_inp = (decoder_inp + spk) * tgt_nonpadding
        ret["decoder_inp"] = decoder_inp
        return ret, decoder_inp
