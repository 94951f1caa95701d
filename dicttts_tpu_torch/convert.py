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

The discriminators have no converter in the JAX package;
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
from dicttts_tpu_torch.models.flows import ResidualCouplingBlock
from dicttts_tpu_torch.models.fvae import FVAE
from dicttts_tpu_torch.models.hifigan import HifiGanDiscriminator, HifiGanGenerator
from dicttts_tpu_torch.models.layers import RelTransformerLayers
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


def rel_layers_state(p: dict, n_layers: int, prefix: str = "") -> dict:
    out: dict = {}
    for i in range(n_layers):
        attn = p[f"RelMultiHeadAttention_{i}"]
        for ours, theirs in (("q", "conv_q"), ("k", "conv_k"), ("v", "conv_v"), ("out", "conv_o")):
            _dense_1x1(out, f"{prefix}attn_layers.{i}.{theirs}", attn[ours])
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
