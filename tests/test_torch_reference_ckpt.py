"""Reference PyTorch checkpoints into the port (dicttts_tpu_torch.utils.reference_ckpt
and tools/convert_torch_ckpt.py) against the JAX package's converter
(dicttts_tpu.utils.torch_convert).

A state dict in the reference's layout is built from seeded weights by
chip_smoke.py's ``reference_layout`` (phase 15a): weight norm split into
``weight_g`` / ``weight_v`` on every convolution the JAX converter folds (all
of them but the attention's 1x1 q/k/v/o, which it reads as they are, and a
coupling's ``pre``, whose plain ``weight`` it takes as the sign that the
prior flow is there), and the reference's unused keys present. The same dict goes into the port through
``load_reference_*`` and into the JAX models through ``convert_*``; their
outputs are held to the parity tests' tolerances (Dict-TTS: mel2word exact,
mel_out atol 1e-4, as tests/test_torch_dict_tts.py; HiFi-GAN atol 1e-4, as
tests/test_torch_hifigan.py).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dicttts_tpu.models.dict_encoder import DictMsg as JMsg
from dicttts_tpu.models.dict_tts import DictTTS as JDictTTS
from dicttts_tpu.models.hifigan import HifiGanGenerator as JGen
from dicttts_tpu.utils import torch_convert
from dicttts_tpu_torch.models.dict_encoder import DictMsg
from dicttts_tpu_torch.models.dict_tts import DictTTS
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.tools import convert_torch_ckpt
from dicttts_tpu_torch.utils import reference_ckpt
from dicttts_tpu_torch.utils.checkpoint import load_checkpoint, load_partial
from test_torch_dict_tts import E, KW, MAX_FRAMES, _data

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

HIFI_CFG = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
                resblock_kernel_sizes=(3, 7, 11))
UNUSED_SHAPES = {"sin_pos._float_tensor": (1,), "enc_pos_proj.weight": (32, 64), "enc_pos_proj.bias": (32,),
                 "dec_query_proj.weight": (32, 64), "dec_query_proj.bias": (32,),
                 "dec_res_proj.weight": (32, 64), "dec_res_proj.bias": (32,),
                 "attn.in_proj_weight": (96, 32), "attn.out_proj.weight": (32, 32),
                 "dict_encoder.S2PA_module.emb.weight": (40, 32)}


def _seeded(module: nn.Module, seed: int, scale: float) -> nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return module


def reference_layout(module: nn.Module, seed: int, unused: dict | None = None) -> tuple[dict, int]:
    """chip_smoke.py's reference layout (phase 15a) of ``module`` from ``seed``."""
    return chip_smoke.reference_layout(module, np.random.RandomState(seed), unused)


def _dict_tts_pair(seed):
    src = _seeded(DictTTS(dict_embed_dim=E, **KW), seed, 0.3)
    state, n_folded = reference_layout(src, seed + 1, UNUSED_SHAPES)
    port = DictTTS(dict_embed_dim=E, **KW)
    report = reference_ckpt.load_reference_dict_tts(port, state)
    assert report == {"folded": n_folded, "dropped": sorted(UNUSED_SHAPES)}
    assert n_folded > 40
    params = torch_convert.convert_dict_tts(
        {k: v.numpy() for k, v in state.items()}, dur_predictor_layers=KW["dur_predictor_layers"],
        enc_n_layers=4, fvae_enc_n_layers=KW["fvae_enc_n_layers"], fvae_dec_n_layers=KW["fvae_dec_n_layers"],
        prior_flow_n_blocks=KW["prior_flow_n_blocks"])
    return port.eval(), params


def test_load_torch_checkpoint_formats_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    child = {"a.weight": torch.tensor(rng.randn(3, 2)), "b.bias": torch.tensor(rng.randn(4))}
    formats = {
        "task": {"state_dict": {"model": child, "mel_disc": {"c.weight": torch.ones(2)}, "steps": 5},
                 "global_step": 5},
        "vocoder_yaml": {"state_dict": {"model_gen": child}},
        "vocoder_json": {"generator": child},
        "plain": {**child, "version": 3},
    }
    for name, ckpt in formats.items():
        path = str(tmp_path / f"{name}.ckpt")
        torch.save(ckpt, path)
        got = reference_ckpt.load_torch_checkpoint(path)
        want = torch_convert.load_torch_checkpoint(path)
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{name}: {k}")
    assert sorted(reference_ckpt.load_torch_checkpoint(str(tmp_path / "task.ckpt"))) == [
        "mel_disc.c.weight", "model.a.weight", "model.b.bias"]
    assert reference_ckpt.strip_prefix({"model.x": 1, "mel_disc.y": 2}, "model.") == {"x": 1}


def test_fold_weight_norm_matches_jax():
    rng = np.random.RandomState(1)
    for shape in ((6, 4, 5), (4, 6, 8), (3, 7)):
        v = rng.randn(*shape).astype(np.float32)
        g = rng.rand(shape[0], *(1,) * (len(shape) - 1)).astype(np.float32)
        np.testing.assert_array_equal(reference_ckpt.fold_weight_norm(v, g),
                                      torch_convert.fold_weight_norm(v, g))


@pytest.mark.parametrize("seed", [0, 1])
def test_dict_tts_reference_state_matches_jax_converter(seed, monkeypatch):
    port, params = _dict_tts_pair(seed * 10)
    bank, km, pin, pm, wt, pron, noise = _data(seed)
    jm = JDictTTS(dropout=0.0, predictor_dropout=0.0, **KW)
    jkeys = jnp.asarray(bank)
    dm = JMsg(jkeys, jkeys, jnp.asarray(km[wt]), jnp.asarray(pin[wt]), jnp.asarray(pm[wt]))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    apply = jax.jit(lambda p, w, d, pr, r: jm.apply({"params": p}, w, d, pr, infer=True,
                                                      max_frames=MAX_FRAMES, rngs={"sample": r}))
    ref = apply(params, jnp.asarray(wt), dm, jnp.asarray(pron), jax.random.PRNGKey(2))
    tkeys = torch.tensor(bank)
    tdm = DictMsg(tkeys, tkeys, torch.tensor(km[wt]), torch.tensor(pin[wt]), torch.tensor(pm[wt]))
    with torch.no_grad():
        out = port(torch.tensor(wt), tdm, torch.tensor(pron), max_frames=MAX_FRAMES, noise=torch.tensor(noise))
    m2w = np.asarray(ref["mel2word"])
    np.testing.assert_array_equal(out["mel2word"].numpy(), m2w)
    n = (m2w > 0).sum(1)
    assert n.min() > 0 and n.max() < MAX_FRAMES, n
    np.testing.assert_allclose(out["mel_out"].numpy(), np.asarray(ref["mel_out"]), atol=1e-4)


def test_hifigan_reference_state_matches_jax_converter():
    """ResBlock1, the layout convert_hifigan_generator reads (convs1/convs2)."""
    src = _seeded(HifiGanGenerator(**HIFI_CFG), 3, 0.2)
    state, n_folded = reference_layout(src, 4)
    port = HifiGanGenerator(**HIFI_CFG)
    assert reference_ckpt.load_reference_hifigan(port, state) == {"folded": n_folded, "dropped": []}
    assert n_folded == 2 + 2 + 2 * 3 * 6  # conv_pre, conv_post, ups, 6 convs in each of 2 x 3 blocks
    params = torch_convert.convert_hifigan_generator({k: v.numpy() for k, v in state.items()},
                                                     upsample_rates=HIFI_CFG["upsample_rates"])
    mel = np.random.RandomState(5).randn(2, 20, 80).astype(np.float32)
    ref = np.asarray(jax.jit(JGen(fold_lanes=False, **HIFI_CFG).apply)(
        {"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        out = port.eval()(torch.tensor(mel)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_strict_keys_raise():
    src = _seeded(HifiGanGenerator(**HIFI_CFG), 6, 0.2)
    state, _ = reference_layout(src, 7)
    with pytest.raises(RuntimeError, match="Unexpected key.*m_source"):
        reference_ckpt.load_reference_hifigan(HifiGanGenerator(**HIFI_CFG), {**state, "m_source.w": torch.ones(1)})
    missing = {k: v for k, v in state.items() if not k.startswith("conv_post.")}
    with pytest.raises(RuntimeError, match="Missing key.*conv_post"):
        reference_ckpt.load_reference_hifigan(HifiGanGenerator(**HIFI_CFG), missing)
    lone = {k: v for k, v in state.items() if k != "conv_pre.weight_g"}
    with pytest.raises(KeyError, match="conv_pre.weight_g"):
        reference_ckpt.load_reference_hifigan(HifiGanGenerator(**HIFI_CFG), lone)
    dict_state, _ = reference_layout(_seeded(DictTTS(dict_embed_dim=E, **KW), 8, 0.3), 9, UNUSED_SHAPES)
    with pytest.raises(RuntimeError, match="Unexpected key.*dec_output_proj"):
        reference_ckpt.load_reference_dict_tts(DictTTS(dict_embed_dim=E, **KW),
                                               {**dict_state, "dec_output_proj.weight": torch.ones(2)})


TINY_DICT_TTS = ("word_size=40,hidden_size=16,value_embedding_size=30,dict_embed_dim=32,dur_predictor_layers=2,"
                 "dur_predictor_kernel=3,latent_size=4,fvae_enc_dec_hidden=16,fvae_kernel_size=3,"
                 "fvae_enc_n_layers=1,fvae_dec_n_layers=1,prior_glow_hidden=8,glow_kernel_size=3,"
                 "prior_glow_n_blocks=1")
TINY_HIFIGAN = "upsample_rates=[4 4],upsample_kernel_sizes=[8 8],upsample_initial_channel=16"


@pytest.mark.parametrize("model,hparams,layout", [
    ("dict_tts", TINY_DICT_TTS, "task"), ("hifigan", TINY_HIFIGAN, "generator"),
    ("hifigan", TINY_HIFIGAN, "model_gen")])
def test_cli_checkpoint_reloads_bit_for_bit(model, hparams, layout, tmp_path, capsys):
    from dicttts_tpu_torch.config import load_config

    cfg = load_config(config=f"{convert_torch_ckpt.CONFIG_DIR}/{convert_torch_ckpt.CONFIGS[model]}",
                      overrides=hparams, save=False)
    src = _seeded(convert_torch_ckpt.build_module(model, cfg), 11, 0.2)
    state, n_folded = reference_layout(src, 12, UNUSED_SHAPES if model == "dict_tts" else None)
    ckpt = {"task": {"state_dict": {"model": state, "mel_disc": {"x.weight": torch.ones(3)}}, "global_step": 9},
            "generator": {"generator": state}, "model_gen": {"state_dict": {"model_gen": state}}}[layout]
    torch.save(ckpt, tmp_path / "ref.ckpt")
    out = convert_torch_ckpt.main(["--model", model, "--src", str(tmp_path / "ref.ckpt"),
                                   "--dst", str(tmp_path / "conv"), "--step", "7", "--hparams", hparams])
    assert out["path"].endswith("model_ckpt_steps_7.ckpt") and out["folded"] == n_folded
    assert f"{n_folded} weight-norm pairs folded" in capsys.readouterr().out
    step, saved = load_checkpoint(out["path"])
    assert step == 7 and list(saved) == ["params_g"]
    want = convert_torch_ckpt.build_module(model, cfg)
    loader = reference_ckpt.load_reference_dict_tts if model == "dict_tts" else reference_ckpt.load_reference_hifigan
    loader(want, {k: v.clone() for k, v in state.items()})
    assert list(saved["params_g"]) == list(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(saved["params_g"][k], v), k
    # fine-tuning: every name of a fresh model takes the checkpoint's tensor
    fresh = convert_torch_ckpt.build_module(model, cfg).state_dict()
    loaded, skipped = load_partial(out["path"], fresh)
    assert skipped == [] and all(torch.equal(loaded[k], v) for k, v in want.state_dict().items())
