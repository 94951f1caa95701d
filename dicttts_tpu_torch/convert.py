"""Weight bridge: the JAX package's flax parameter trees -> this port's modules.

``load_jax_params(module, params)`` takes a flax tree as nested dicts of
numpy arrays (``jax.device_get(params)``) and loads it into a port module
with ``load_state_dict(strict=True)``. It is the inverse of the JAX
package's ``utils/torch_convert.py`` converters, whose torch parameter
names the port keeps, so ``convert_dict_tts(port.state_dict())`` gives back
the flax tree exactly. Layout rules:

- Dense kernel [in, out] -> Linear weight [out, in]; a kernel-1 Conv1d
  weight is that with a trailing tap axis [out, in, 1];
- Conv kernel [k, in, out] -> Conv1d weight [out, in, k];
- ConvTranspose kernel [k, in, out] (flipped-adjoint convention) ->
  ConvTranspose1d weight [in, out, k] with the tap axis reversed;
- Conv2d kernel [kh, kw, in, out] (HWIO) -> Conv2d weight [out, in, kh, kw];
- Embedding and LayerNorm parameters are unchanged.

The JAX package has no converter for ``FFTBlocks``, the post-net ``Glow``,
PortaSpeech's word-to-frame projections, FastSpeech2 or TransformerTTS:
``fft_blocks_state``, ``glow_state``, ``portaspeech_state``,
``fastspeech2_state`` and ``transformer_tts_state`` name them directly
(flax's GRU and LSTM cells into torch's fused ``nn.GRU`` / ``nn.LSTM``,
the biases flax lacks set to 0: ``gru_state``, ``lstm_state``); PortaSpeech's
phone encoder, duration predictor and FVAE keep the names its
``convert_rel_encoder``, ``convert_duration_predictor`` and
``convert_fvae`` read. The discriminators have no converter in the JAX package;
``discriminator_state``, ``jcu_state`` and ``hifigan_disc_state`` map
their flax trees directly.
The same functions map a gradient tree, which has the parameters' layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dicttts_tpu_torch.models.dict_encoder import DictEncoder, S2PAAttention
from dicttts_tpu_torch.models.dict_tts import DictTTS
from dicttts_tpu_torch.models.discriminator import JCUDiscriminator, MultiWindowDiscriminator
from dicttts_tpu_torch.models.duration import DurationPredictor
from dicttts_tpu_torch.models.fastspeech2 import FastSpeech2
from dicttts_tpu_torch.models.fft_blocks import FFTBlocks
from dicttts_tpu_torch.models.flows import ResidualCouplingBlock
from dicttts_tpu_torch.models.fvae import FVAE
from dicttts_tpu_torch.models.hifigan import HifiGanDiscriminator, HifiGanGenerator
from dicttts_tpu_torch.models.layers import ConvReluNorm, RelTransformerEncoder, RelTransformerLayers
from dicttts_tpu_torch.models.portaspeech import PortaSpeech
from dicttts_tpu_torch.models.post_glow import Glow
from dicttts_tpu_torch.models.tacotron import BertEncoderScaffold
from dicttts_tpu_torch.models.transformer_tts import TransformerTTS
from dicttts_tpu_torch.models.wavenet import WN


def _dense(kernel) -> np.ndarray:
    return np.asarray(kernel).T


def _conv(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel), (2, 1, 0))


def _conv_transpose(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel), (1, 2, 0))[:, :, ::-1]


def _conv_entry(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _conv(p["kernel"])
    out[f"{name}.bias"] = p["bias"]


def _dense_1x1(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _dense(p["kernel"])[:, :, None]
    out[f"{name}.bias"] = p["bias"]


def _ln(out: dict, name: str, p: dict) -> None:
    out[f"{name}.gamma"] = p["gamma"]
    out[f"{name}.beta"] = p["beta"]


def attn_state(out: dict, prefix: str, p: dict) -> None:
    for ours, theirs in (("q", "conv_q"), ("k", "conv_k"), ("v", "conv_v"), ("out", "conv_o")):
        _dense_1x1(out, f"{prefix}{theirs}", p[ours])


def rel_layers_state(p: dict, n_layers: int, prefix: str = "") -> dict:
    out: dict = {}
    for i in range(n_layers):
        attn = p[f"RelMultiHeadAttention_{i}"]
        attn_state(out, f"{prefix}attn_layers.{i}.", attn)
        if "rel_k" in attn:
            out[f"{prefix}attn_layers.{i}.emb_rel_k"] = attn["rel_k"]
            out[f"{prefix}attn_layers.{i}.emb_rel_v"] = attn["rel_v"]
        _ln(out, f"{prefix}norm_layers_1.{i}", p[f"LayerNorm_{2 * i}"])
        _ln(out, f"{prefix}norm_layers_2.{i}", p[f"LayerNorm_{2 * i + 1}"])
        _conv_entry(out, f"{prefix}ffn_layers.{i}.conv_1", p[f"ConvFFN_{i}"]["Conv_0"])
        _conv_entry(out, f"{prefix}ffn_layers.{i}.conv_2", p[f"ConvFFN_{i}"]["Conv_1"])
    _ln(out, f"{prefix}last_ln", p[f"LayerNorm_{2 * n_layers}"])
    return out


def s2pa_state(p: dict, prefix: str = "") -> dict:
    out = {f"{prefix}{theirs}.weight": _dense(p[ours]["kernel"])
           for ours, theirs in (("q", "q_transform"), ("k", "k_transform"),
                                ("v", "v_transform"), ("out", "output_transform"))}
    out[f"{prefix}pinyin_embedding.weight"] = p["pinyin_embedding"]["embedding"]
    return out


def dict_encoder_state(p: dict, n_layers: int, prefix: str = "") -> dict:
    p = p["s2pa_module"]
    pre = f"{prefix}S2PA_module."
    out = {f"{pre}word_emb.weight": p["word_emb"]["embedding"]}
    out.update(rel_layers_state(p["semantic_encoder"], n_layers, f"{pre}semantic_encoder."))
    out.update(s2pa_state(p["s2pa"], f"{pre}s2pa_attention."))
    out.update(rel_layers_state(p["linguistic_encoder"], n_layers, f"{pre}linguistic_encoder."))
    return out


def duration_state(p: dict, n_layers: int, prefix: str = "") -> dict:
    out: dict = {}
    for i in range(n_layers):
        _conv_entry(out, f"{prefix}conv.{i}.1", p[f"conv_{i}"])
        out[f"{prefix}conv.{i}.3.weight"] = p[f"ln_{i}"]["gamma"]
        out[f"{prefix}conv.{i}.3.bias"] = p[f"ln_{i}"]["beta"]
    out[f"{prefix}linear.0.weight"] = _dense(p["out"]["kernel"])
    out[f"{prefix}linear.0.bias"] = p["out"]["bias"]
    return out


def wn_state(p: dict, n_layers: int, prefix: str = "") -> dict:
    out: dict = {}
    if "cond" in p:
        _conv_entry(out, f"{prefix}cond_layer", p["cond"])
    for i in range(n_layers):
        _conv_entry(out, f"{prefix}in_layers.{i}", p[f"in_{i}"])
        _conv_entry(out, f"{prefix}res_skip_layers.{i}", p[f"res_skip_{i}"])
    return out


def coupling_block_state(p: dict, n_flows: int, wn_layers: int, prefix: str = "") -> dict:
    out: dict = {}
    for i in range(n_flows):
        c, fp = p[f"coupling_{i}"], f"{prefix}flows.{2 * i}."
        _conv_entry(out, f"{fp}pre", c["pre"])
        out.update(wn_state(c["enc"], wn_layers, f"{fp}enc."))
        _conv_entry(out, f"{fp}post", c["post"])
    return out


def fvae_state(p: dict, module: FVAE, prefix: str = "") -> dict:
    out: dict = {}
    for i in range(len(module.g_pre_net)):
        _conv_entry(out, f"{prefix}g_pre_net.{i}", p["g_pre_net"][f"conv_{i}"])
    enc, dec = p["encoder"], p["decoder"]
    for i in range(len(module.encoder.pre_net)):
        _conv_entry(out, f"{prefix}encoder.pre_net.{i}", enc["StridedPreNet_0"][f"conv_{i}"])
    out.update(wn_state(enc["WN_0"], module.encoder.wn.n_layers, f"{prefix}encoder.wn."))
    _conv_entry(out, f"{prefix}encoder.out_proj", enc["out_proj"])
    for i in range(len(module.decoder.pre_net)):
        d = dec["TransposedPreNet_0"][f"deconv_{i}"]
        out[f"{prefix}decoder.pre_net.{i}.weight"] = _conv_transpose(d["kernel"])
        out[f"{prefix}decoder.pre_net.{i}.bias"] = d["bias"]
    out.update(wn_state(dec["WN_0"], module.decoder.wn.n_layers, f"{prefix}decoder.wn."))
    _conv_entry(out, f"{prefix}decoder.out_proj", dec["out_proj"])
    flow = module.prior_flow
    if flow is not None:
        out.update(coupling_block_state(p["prior_flow"], len(flow.flows) // 2,
                                        flow.flows[0].enc.n_layers, f"{prefix}prior_flow."))
    return out


def dict_tts_state(p: dict, module: DictTTS) -> dict:
    enc = module.dict_encoder.S2PA_module
    out = dict_encoder_state(p["dict_encoder"], len(enc.semantic_encoder.attn_layers), "dict_encoder.")
    out.update(duration_state(p["dur_predictor"], len(module.dur_predictor.conv), "dur_predictor."))
    out.update(fvae_state(p["fvae"], module.fvae, "fvae."))
    if module.num_spk > 0:
        out["spk_embed_proj.weight"] = p["spk_embed_proj"]["embedding"]
    return out


def conv_relu_norm_state(p: dict, n_layers: int, prefix: str = "") -> dict:
    out: dict = {}
    for i in range(n_layers):
        _conv_entry(out, f"{prefix}conv_layers.{i}", p[f"Conv_{i}"])
        _ln(out, f"{prefix}norm_layers.{i}", p[f"LayerNorm_{i}"])
    _conv_entry(out, f"{prefix}proj", p[f"Conv_{n_layers}"])
    return out


def rel_encoder_state(p: dict, module: RelTransformerEncoder, prefix: str = "") -> dict:
    out = {f"{prefix}emb.weight": p["Embed_0"]["embedding"]}
    if module.pre is not None:
        out.update(conv_relu_norm_state(p["ConvReluNorm_0"], len(module.pre.conv_layers),
                                        f"{prefix}pre."))
    out.update(rel_layers_state(p["RelTransformerLayers_0"], len(module.encoder.attn_layers),
                                f"{prefix}encoder."))
    return out


def fft_blocks_state(p: dict, module: FFTBlocks, prefix: str = "") -> dict:
    out: dict = {}
    if module.pos_alpha is not None:
        out[f"{prefix}pos_alpha"] = p["SinusoidalPosEmb_0"]["alpha"]
    for i in range(len(module.attn)):
        _ln(out, f"{prefix}ln1.{i}", p[f"ln1_{i}"])
        attn_state(out, f"{prefix}attn.{i}.", p[f"attn_{i}"])
        _ln(out, f"{prefix}ln2.{i}", p[f"ln2_{i}"])
        _conv_entry(out, f"{prefix}ffn1.{i}", p[f"ffn1_{i}"])
        out[f"{prefix}ffn2.{i}.weight"] = _dense(p[f"ffn2_{i}"]["kernel"])
        out[f"{prefix}ffn2.{i}.bias"] = p[f"ffn2_{i}"]["bias"]
    _ln(out, f"{prefix}ln_out", p["ln_out"])
    return out


def glow_state(p: dict, module: Glow, prefix: str = "") -> dict:
    """Glow: flax {'actnorm_<i>', 'invconv_<i>', 'coupling_<i>' (pre, post,
    and enc unless shared), 'shared_wn_<s>'} -> the port's ``state_dict``."""
    out: dict = {}
    for s, wn in enumerate(module.shared_wn):
        out.update(wn_state(p[f"shared_wn_{s}"], wn.n_layers, f"{prefix}shared_wn.{s}."))
    for i, coupling in enumerate(module.coupling):
        out[f"{prefix}actnorm.{i}.logs"] = p[f"actnorm_{i}"]["logs"]
        out[f"{prefix}actnorm.{i}.bias"] = p[f"actnorm_{i}"]["bias"]
        out[f"{prefix}invconv.{i}.weight"] = p[f"invconv_{i}"]["weight"]
        c = p[f"coupling_{i}"]
        _conv_entry(out, f"{prefix}coupling.{i}.pre", c["pre"])
        if coupling.enc is not None:
            out.update(wn_state(c["enc"], coupling.enc.n_layers, f"{prefix}coupling.{i}.enc."))
        _conv_entry(out, f"{prefix}coupling.{i}.post", c["post"])
    return out


def portaspeech_state(p: dict, module: PortaSpeech) -> dict:
    """PortaSpeech: the phone encoder and the duration predictor and FVAE
    under the reference's torch names (which the JAX package's
    ``convert_rel_encoder``, ``convert_duration_predictor`` and
    ``convert_fvae`` read), the word encoder, the word-to-frame projections
    (Linear, no bias) and the post-net Glow."""
    out = rel_encoder_state(p["ph_encoder"], module.ph_encoder, "ph_encoder.")
    out.update(fft_blocks_state(p["word_encoder"], module.word_encoder, "word_encoder."))
    for name in ("enc_pos_proj", "dec_query_proj", "dec_res_proj", "attn_out"):
        out[f"{name}.weight"] = _dense(p[name]["kernel"])
    out.update(duration_state(p["dur_predictor"], len(module.dur_predictor.conv), "dur_predictor."))
    out.update(fvae_state(p["fvae"], module.fvae, "fvae."))
    if module.num_spk > 0:
        out["spk_embed_proj.weight"] = p["spk_embed_proj"]["embedding"]
    if module.post_flow is not None:
        out.update(glow_state(p["post_flow"], module.post_flow, "post_flow."))
    return out


def _linear(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _dense(p["kernel"])
    if "bias" in p:
        out[f"{name}.bias"] = p["bias"]


def gru_state(fwd: dict, bwd: dict, prefix: str) -> dict:
    """flax ``GRUCell`` pair (forward, reversed) -> a bidirectional
    ``nn.GRU``: gates (r, z, n); b_hr = b_hz = 0, b_hn = hn.bias."""
    out: dict = {}
    for suffix, c in (("", fwd), ("_reverse", bwd)):
        H = np.shape(c["hn"]["bias"])[0]
        out[f"{prefix}weight_ih_l0{suffix}"] = np.concatenate([_dense(c[g]["kernel"]) for g in ("ir", "iz", "in")])
        out[f"{prefix}bias_ih_l0{suffix}"] = np.concatenate([c[g]["bias"] for g in ("ir", "iz", "in")])
        out[f"{prefix}weight_hh_l0{suffix}"] = np.concatenate([_dense(c[g]["kernel"]) for g in ("hr", "hz", "hn")])
        out[f"{prefix}bias_hh_l0{suffix}"] = np.concatenate([np.zeros(2 * H, np.float32), c["hn"]["bias"]])
    return out


def lstm_state(fwd: dict, bwd: dict, prefix: str) -> dict:
    """flax ``OptimizedLSTMCell`` pair -> a bidirectional ``nn.LSTM``:
    gates (i, f, g, o); b_ih = 0, b_hh = the h paths' biases."""
    out: dict = {}
    for suffix, c in (("", fwd), ("_reverse", bwd)):
        gates = ("i", "f", "g", "o")
        H = np.shape(c["hi"]["bias"])[0]
        out[f"{prefix}weight_ih_l0{suffix}"] = np.concatenate([_dense(c[f"i{g}"]["kernel"]) for g in gates])
        out[f"{prefix}bias_ih_l0{suffix}"] = np.zeros(4 * H, np.float32)
        out[f"{prefix}weight_hh_l0{suffix}"] = np.concatenate([_dense(c[f"h{g}"]["kernel"]) for g in gates])
        out[f"{prefix}bias_hh_l0{suffix}"] = np.concatenate([c[f"h{g}"]["bias"] for g in gates])
    return out


def _norm_conv(out: dict, name: str, p: dict) -> None:
    out[f"{name}.conv.weight"] = _conv(p["Conv_0"]["kernel"])
    _ln(out, f"{name}.norm", p["LayerNorm_0"])


def conformer_state(p: dict, n_layers: int, prefix: str = "") -> dict:
    """ConformerLayers: {'block_<i>': {ConformerFF_0/1, LayerNorm_0/1,
    RelMultiHeadAttention_0, ConformerConvModule_0}}."""
    out: dict = {}
    for i in range(n_layers):
        b, pre = p[f"block_{i}"], f"{prefix}blocks.{i}."
        for ff, name in (("ConformerFF_0", "ff1"), ("ConformerFF_1", "ff2")):
            _ln(out, f"{pre}{name}.ln", b[ff]["LayerNorm_0"])
            _linear(out, f"{pre}{name}.fc1", b[ff]["Dense_0"])
            _linear(out, f"{pre}{name}.fc2", b[ff]["Dense_1"])
        _ln(out, f"{pre}ln_attn", b["LayerNorm_0"])
        attn_state(out, f"{pre}attn.", b["RelMultiHeadAttention_0"])
        c = b["ConformerConvModule_0"]
        _ln(out, f"{pre}conv_module.ln1", c["LayerNorm_0"])
        _linear(out, f"{pre}conv_module.pw1", c["Dense_0"])
        _conv_entry(out, f"{pre}conv_module.depthwise", c["depthwise"])
        _ln(out, f"{pre}conv_module.ln2", c["LayerNorm_1"])
        _linear(out, f"{pre}conv_module.pw2", c["Dense_1"])
        _ln(out, f"{pre}ln_out", b["LayerNorm_1"])
    return out


def _fs2_encoder_state(p: dict, module: FastSpeech2) -> dict:
    kind, enc = module.encoder_type, module.encoder
    if kind == "rel_fft":
        return rel_encoder_state(p, enc, "encoder.")
    out = {"encoder.embed.weight": p["Embed_0"]["embedding"]}
    if kind == "fft":
        out.update(fft_blocks_state(p["FFTBlocks_0"], enc.layers, "encoder.layers."))
    elif kind == "conformer":
        out.update(conformer_state(p["ConformerLayers_0"], len(enc.layers.blocks), "encoder.layers."))
    elif kind == "tacotron":
        _linear(out, "encoder.prenet.fc1", p["PreNet_0"]["Dense_0"])
        _linear(out, "encoder.prenet.fc2", p["PreNet_0"]["Dense_1"])
        c, cbhg = p["CBHG_0"], enc.cbhg
        for k in range(1, len(cbhg.bank) + 1):
            _norm_conv(out, f"encoder.cbhg.bank.{k - 1}", c[f"bank_{k}"])
        _norm_conv(out, "encoder.cbhg.proj1", c["proj1"])
        _norm_conv(out, "encoder.cbhg.proj2", c["proj2"])
        if cbhg.pre_highway is not None:
            _linear(out, "encoder.cbhg.pre_highway", c["pre_highway"])
        for i in range(len(cbhg.highways)):
            _linear(out, f"encoder.cbhg.highways.{i}.W1", c[f"highway_{i}"]["W1"])
            _linear(out, f"encoder.cbhg.highways.{i}.W2", c[f"highway_{i}"]["W2"])
        g = c["BiGRU_0"]
        out.update(gru_state(g["GRUCell_0"], g["GRUCell_1"], "encoder.cbhg.rnn.rnn."))
        _linear(out, "encoder.proj", p["Dense_0"])
    elif kind == "tacotron2":
        for i in range(len(enc.convs)):
            _norm_conv(out, f"encoder.convs.{i}", p[f"conv_{i}"])
        r = p["BiLSTM_0"]
        out.update(lstm_state(r["OptimizedLSTMCell_0"], r["OptimizedLSTMCell_1"], "encoder.rnn.rnn."))
    else:
        raise TypeError(f"no flax mapping for FastSpeech2 encoder {kind!r}")
    return out


def _fs2_decoder_state(p: dict, module: FastSpeech2) -> dict:
    kind, dec = module.decoder_type, module.decoder
    out: dict = {}
    if kind == "fft":
        out.update(fft_blocks_state(p["FFTBlocks_0"], dec, "decoder."))
    elif kind == "conv":
        for i in range(len(dec.convs)):
            _conv_entry(out, f"decoder.convs.{i}", p[f"conv_{i}"])
            _ln(out, f"decoder.norms.{i}", p[f"ln_{i}"])
    elif kind == "wn":
        out.update(wn_state(p["WN_0"], dec.wn.n_layers, "decoder.wn."))
    elif kind == "conformer":
        out.update(conformer_state(p["ConformerLayers_0"], len(dec.blocks), "decoder."))
    elif kind == "rnn":
        _conv_entry(out, "decoder.conv1", p["Conv_0"])
        _conv_entry(out, "decoder.conv2", p["Conv_1"])
        _ln(out, "decoder.norm", p["LayerNorm_0"])
        r = p["BiLSTM_0"]
        out.update(lstm_state(r["OptimizedLSTMCell_0"], r["OptimizedLSTMCell_1"], "decoder.rnn.rnn."))
        _conv_entry(out, "decoder.conv_out", p["Conv_2"])
    else:
        raise TypeError(f"no flax mapping for FastSpeech2 decoder {kind!r}")
    return out


def _predictor_state(out: dict, prefix: str, p: dict, n_layers: int) -> None:
    for i in range(n_layers):
        _conv_entry(out, f"{prefix}convs.{i}", p[f"conv_{i}"])
        _ln(out, f"{prefix}norms.{i}", p[f"ln_{i}"])
    _linear(out, f"{prefix}out", p["out"])


def fastspeech2_state(p: dict, module: FastSpeech2) -> dict:
    """FastSpeech2 with any registry entry, its predictors, embeddings,
    RefEncoder and speaker embedding."""
    out = _fs2_encoder_state(p["encoder"], module)
    out.update(_fs2_decoder_state(p["decoder"], module))
    _linear(out, "mel_head", p["mel_head"])
    out.update(duration_state(p["dur_predictor"], len(module.dur_predictor.conv), "dur_predictor."))
    if module.use_pitch_embed:
        out["pitch_embed.weight"] = p["pitch_embed"]["embedding"]
        _predictor_state(out, "pitch_predictor.", p["pitch_predictor"],
                         len(module.pitch_predictor.convs))
    if module.use_energy_embed:
        out["energy_embed.weight"] = p["energy_embed"]["embedding"]
        _predictor_state(out, "energy_predictor.", p["energy_predictor"]["PitchPredictor_0"],
                         len(module.energy_predictor.convs))
    if module.use_ref_enc:
        r = p["ref_encoder"]
        for i in range(len(module.ref_encoder.convs)):
            _conv_entry(out, f"ref_encoder.convs.{i}", r[f"conv_{i}"])
            _ln(out, f"ref_encoder.norms.{i}", r[f"ln_{i}"])
        _linear(out, "ref_encoder.proj", r["proj"])
    if module.num_spk > 0:
        out["spk_embed_proj.weight"] = p["spk_embed_proj"]["embedding"]
    return out


def transformer_tts_state(p: dict, module: TransformerTTS) -> dict:
    """TransformerTTS: the flax module's names, layer i's under
    ``dec_layers.<i>``."""
    out = {"embed.weight": p["embed"]["embedding"], "dec_pos_alpha": p["dec_pos_alpha"]}
    out.update(fft_blocks_state(p["encoder"], module.encoder, "encoder."))
    for name in ("prenet_fc1", "prenet_fc2", "prenet_fc3", "project_out"):
        _linear(out, name, p[name])
    for i in range(len(module.dec_layers)):
        d, pre = p[f"dec_layer_{i}"], f"dec_layers.{i}."
        for ln in ("ln1", "ln2", "ln3"):
            _ln(out, f"{pre}{ln}", d[ln])
        for attn in ("self_attn", "cross_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _linear(out, f"{pre}{attn}.{proj}", d[attn][proj])
        _conv_entry(out, f"{pre}ffn_conv", d["ffn_conv"])
        _linear(out, f"{pre}ffn_out", d["ffn_out"])
    _ln(out, "dec_ln", p["dec_ln"])
    if module.num_spk > 0:
        out["spk_embed.weight"] = p["spk_embed"]["embedding"]
    return out


def hifigan_state(p: dict, module: HifiGanGenerator) -> dict:
    out: dict = {}
    _conv_entry(out, "conv_pre", p["conv_pre"])
    nk = module.num_kernels
    for i in range(len(module.ups)):
        out[f"ups.{i}.weight"] = _conv_transpose(p[f"up_{i}"]["kernel"])
        out[f"ups.{i}.bias"] = p[f"up_{i}"]["bias"]
        for j in range(nk):
            blk, r = p[f"res_{i}_{j}"], i * nk + j
            rb = module.resblocks[r]
            if hasattr(rb, "convs1"):
                for d in range(len(rb.convs1)):
                    out[f"resblocks.{r}.convs1.{d}.weight"] = _conv(blk[f"conv1_{d}_kernel"])
                    out[f"resblocks.{r}.convs1.{d}.bias"] = blk[f"conv1_{d}_bias"]
                    out[f"resblocks.{r}.convs2.{d}.weight"] = _conv(blk[f"conv2_{d}_kernel"])
                    out[f"resblocks.{r}.convs2.{d}.bias"] = blk[f"conv2_{d}_bias"]
            else:
                for d in range(len(rb.convs)):
                    _conv_entry(out, f"resblocks.{r}.convs.{d}", blk[f"conv_{d}"])
    out["conv_post.weight"] = _conv(p["conv_post_kernel"])
    out["conv_post.bias"] = p["conv_post_bias"]
    return out


def discriminator_state(params_d: dict) -> dict:
    """MultiWindowDiscriminator: flax tree {'win_<w>': {'conv_<i>', 'in_gamma_<i>',
    'in_beta_<i>', 'adv'}} -> the port's ``state_dict``."""
    out: dict = {}
    for win, p in params_d.items():
        pre = f"discs.{win}."
        for name, leaf in p.items():
            if name.startswith("conv_"):
                out[f"{pre}{name}.weight"] = np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1))
                out[f"{pre}{name}.bias"] = leaf["bias"]
            elif name == "adv":
                out[f"{pre}adv.weight"] = _dense(leaf["kernel"])
                out[f"{pre}adv.bias"] = leaf["bias"]
            else:  # in_gamma_<i>, in_beta_<i>
                out[f"{pre}{name}"] = leaf
    return out


def jcu_state(params: dict) -> dict:
    """JCUDiscriminator: flax tree {'<conv name>': {'kernel', 'bias'}} -> the
    port's ``state_dict`` (the same layer names)."""
    out: dict = {}
    for name, leaf in params.items():
        _conv_entry(out, name, leaf)
    return out


def hifigan_disc_state(params_d: dict) -> dict:
    """HiFi-GAN's discriminators: the JAX task's {'mpd': {'disc_p<p>': ...},
    'msd': {'disc_s<i>': ...}}, each sub-discriminator {'conv_<i>' |
    'conv_post': {'kernel', 'bias'}} (HWIO 2-D kernels in the MPD, grouped
    [k, in / groups, out] 1-D kernels in the MSD) -> the port's
    ``HifiGanDiscriminator.state_dict``."""
    out: dict = {}
    for group, subs in params_d.items():
        for sub, convs in subs.items():
            for name, leaf in convs.items():
                kernel = np.asarray(leaf["kernel"])
                key = f"{group}.discs.{sub}.{name}"
                out[f"{key}.weight"] = (np.transpose(kernel, (3, 2, 0, 1)) if kernel.ndim == 4
                                        else _conv(kernel))
                out[f"{key}.bias"] = leaf["bias"]
    return out


def jax_params_to_state(module: nn.Module, params: dict) -> dict:
    """The port ``state_dict`` (numpy arrays) equivalent to a flax tree."""
    if isinstance(module, DictTTS):
        return dict_tts_state(params, module)
    if isinstance(module, PortaSpeech):
        return portaspeech_state(params, module)
    if isinstance(module, FastSpeech2):
        return fastspeech2_state(params, module)
    if isinstance(module, TransformerTTS):
        return transformer_tts_state(params, module)
    if isinstance(module, BertEncoderScaffold):
        out = fft_blocks_state(params["FFTBlocks_0"], module.blocks, "blocks.")
        _linear(out, "out", params["Dense_0"])
        return out
    if isinstance(module, Glow):
        return glow_state(params, module)
    if isinstance(module, RelTransformerEncoder):
        return rel_encoder_state(params, module)
    if isinstance(module, ConvReluNorm):
        return conv_relu_norm_state(params, len(module.conv_layers))
    if isinstance(module, FFTBlocks):
        return fft_blocks_state(params, module)
    if isinstance(module, HifiGanGenerator):
        return hifigan_state(params, module)
    if isinstance(module, HifiGanDiscriminator):
        return hifigan_disc_state(params)
    if isinstance(module, MultiWindowDiscriminator):
        return discriminator_state(params)
    if isinstance(module, JCUDiscriminator):
        return jcu_state(params)
    if isinstance(module, DictEncoder):
        return dict_encoder_state(params, len(module.S2PA_module.semantic_encoder.attn_layers))
    if isinstance(module, S2PAAttention):
        return s2pa_state(params)
    if isinstance(module, RelTransformerLayers):
        return rel_layers_state(params, len(module.attn_layers))
    if isinstance(module, DurationPredictor):
        return duration_state(params, len(module.conv))
    if isinstance(module, WN):
        return wn_state(params, module.n_layers)
    if isinstance(module, ResidualCouplingBlock):
        return coupling_block_state(params, len(module.flows) // 2, module.flows[0].enc.n_layers)
    if isinstance(module, FVAE):
        return fvae_state(params, module)
    raise TypeError(f"no flax mapping for {type(module).__name__}")


def load_jax_params(module: nn.Module, params: dict) -> nn.Module:
    """Load a flax parameter tree (nested dicts of arrays) into ``module``."""
    state = {k: torch.tensor(np.array(v, dtype=np.float32))
             for k, v in jax_params_to_state(module, params).items()}
    module.load_state_dict(state, strict=True)
    return module
