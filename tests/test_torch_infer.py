"""Port parity of text -> wav: dicttts_tpu_torch.infer.DictTTSInferencer
against dicttts_tpu.infer.DictTTSInferencer on the CPU, with the repo's
word_set.json, pinyin_encoder.pkl and dict_embed (.prod_corpus/binary),
its dictionary (.prod_corpus/zh-dict.json) and a few PER test sentences
(data/per_test_set.json), at small model widths with dict_embed_dim 768.

Both inferencers get the same parameters (the JAX flax trees, converted by
dicttts_tpu_torch.convert) and the same prior noise (patched into
jax.random.normal on the JAX side, given as ``noise`` to the port).
Tolerances: the front end, _prepare, _collate, n_frames and the pinyin
exact; mel atol 1e-4 and wav atol 2e-4, as tests/test_torch_serve.py
holds them (f32 on the CPU, summation orders only). With use_pallas_s2pa
the JAX side runs K3 in interpret mode and the port its plain version.

Also the vocoder API (HifiGanVocoder.spec2wav in f32 and bf16, wav2spec,
the registry), the mel and mu-law ops against JAX, and one check over the
port's sources: no module of dicttts_tpu_torch and nothing in
chip_smoke.py imports jax or the JAX package, lazily or not.
"""

import ast
import functools
import glob
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu import infer as jinfer
from dicttts_tpu.models.hifigan import HifiGanGenerator as JGen
from dicttts_tpu.ops import mel as jmel
from dicttts_tpu.ops import pcm as jpcm
from dicttts_tpu.ops import s2pa_pallas
from dicttts_tpu.vocoders.hifigan import HifiGanVocoder as JVocoder
from dicttts_tpu_torch import infer as tinfer
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params
from dicttts_tpu_torch.data.collate import shape_bucket
from dicttts_tpu_torch.eval.metrics import Timer
from dicttts_tpu_torch.ops import mel as tmel
from dicttts_tpu_torch.ops import pcm as tpcm
from dicttts_tpu_torch.text.sandhi import FixedSandhi
from dicttts_tpu_torch.vocoders import HifiGanVocoder, get_vocoder_cls
from dicttts_tpu_torch.vocoders.hifigan import load_wav

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORPUS = os.path.join(ROOT, ".prod_corpus", "binary")
MAX_FRAMES, LATENT, HOP = 160, 4, 16
VOC = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
           resblock_kernel_sizes=(3,))
with open(os.path.join(ROOT, "data", "per_test_set.json"), encoding="utf-8") as _f:
    TEXTS = [d["text"] for d in json.load(_f)][:3]
NOISE = np.random.RandomState(7).randn(len(TEXTS), MAX_FRAMES // 4, LATENT).astype(np.float32)


def _cfg(**over):
    with open(os.path.join(CORPUS, "word_set.json")) as f:
        n_words = len(json.load(f))
    return dict(binary_data_dir=CORPUS, dict_path=os.path.join(ROOT, ".prod_corpus", "zh-dict.json"),
                txt_processor="zh_dict", word_size=n_words + 3, value_embedding_size=168,
                dict_embed_dim=768, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dropout=0.0,
                dur_predictor_layers=2, dur_predictor_kernel=3, predictor_dropout=0.0,
                frames_multiple=4, latent_size=LATENT, fvae_enc_dec_hidden=16, fvae_kernel_size=5,
                fvae_enc_n_layers=1, fvae_dec_n_layers=2, prior_glow_hidden=8, glow_kernel_size=3,
                prior_glow_n_blocks=2, max_frames=MAX_FRAMES, mel_disc_hidden_size=8,
                disc_win_num=1, hop_size=HOP, work_dir="", **VOC, **over)


def _random_params(init, seed, scale):
    """Seeded random values in the shapes of a flax init (traced, not run)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), shapes)


def _jax_inferencer(cfg, params_g, vocoder):
    """The JAX inferencer with given acoustic parameters and vocoder (its
    vocoder's own init, run eagerly, would take ~20 s on the CPU; one
    vocoder instance compiles its graph once)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinfer, "get_vocoder_cls", lambda name: lambda cfg: vocoder)
        return jinfer.DictTTSInferencer(cfg, state={"params_g": params_g})


@pytest.fixture(scope="module")
def world():
    """The JAX inferencer (random acoustic and vocoder weights) and the
    port's, loaded with the same values."""
    cfg = _cfg()
    jt = jinfer.DictTTSTask(cfg)
    params_g = _random_params(lambda r: jt.build_state(r)["params_g"], 1, 0.3)
    # a duration bias of 1.0 gives a few frames a word, so the FVAE and the
    # vocoder see speech-like lengths
    params_g["dur_predictor"]["out"]["bias"] = np.full((1,), 1.0, np.float32)
    voc_params = _random_params(lambda r: JGen(**VOC).init(r, jnp.zeros((1, 16, 80)))["params"], 2, 0.2)
    module = tinfer.DictTTSTask(cfg, device="cpu").build_model()
    state = {k: torch.tensor(np.array(v, np.float32))
             for k, v in jax_params_to_state(module, params_g).items()}
    t = tinfer.DictTTSInferencer(cfg, state={"params_g": state}, device="cpu")
    load_jax_params(t.vocoder.generator, voc_params)
    vocoder = JVocoder(cfg, params=voc_params)
    return {"cfg": cfg, "port": t, "params_g": params_g, "vocoder": vocoder,
            "jax": _jax_inferencer(cfg, params_g, vocoder)}


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def test_prepare_and_collate_match_jax(world):
    j, t = world["jax"], world["port"]
    feats_j = [j._prepare(x) for x in TEXTS]
    feats_t = [t._prepare(x) for x in TEXTS]
    for fj, ft in zip(feats_j, feats_t):
        _assert_same(ft, fj, "prepare")
        assert ft["bank"]["values"] is ft["bank"]["keys"]
    batch_t = t._collate(feats_t)
    _assert_same(batch_t, j._collate(feats_j), "collate")
    assert batch_t["values"] is batch_t["keys"]
    assert batch_t["keys"].shape[-1] == 768 and batch_t["keys"].shape[2] % 8 == 0


@pytest.fixture(scope="module")
def jax_results(world):
    """The JAX inferencer's synthesize_batch on TEXTS with pinned prior
    noise, with use_pallas_s2pa off and on (K3 in interpret mode)."""
    out = {}
    for use_pallas in (False, True):
        j = _jax_inferencer(dict(world["cfg"], use_pallas_s2pa=use_pallas), world["params_g"],
                            world["vocoder"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(s2pa_pallas, "s2pa_fused", functools.partial(s2pa_pallas.s2pa_fused, interpret=True))
            mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(NOISE, dtype))
            out[use_pallas] = j.synthesize_batch(TEXTS, seed=3)
    return out


@pytest.mark.parametrize("use_pallas_s2pa", [False, True])
def test_synthesize_batch_matches_jax(world, jax_results, use_pallas_s2pa):
    t = world["port"]
    s2pa = t.task.model.dict_encoder.S2PA_module.s2pa_attention
    s2pa.use_pallas = use_pallas_s2pa
    try:
        got = t.synthesize_batch(TEXTS, seed=3, noise=torch.tensor(NOISE))
    finally:
        s2pa.use_pallas = False
    for (wav, info), (wav_j, info_j) in zip(got, jax_results[use_pallas_s2pa]):
        assert info["n_frames"] == info_j["n_frames"] and 8 < info["n_frames"] < MAX_FRAMES
        assert info["pinyin"] == info_j["pinyin"] and info["text"] == info_j["text"]
        np.testing.assert_allclose(info["mel"], info_j["mel"], atol=1e-4)
        assert wav.shape == wav_j.shape == (info["n_frames"] * HOP,)
        np.testing.assert_allclose(wav, wav_j, atol=2e-4)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_synthesize_writes_the_wav_and_times_the_stages(world, tmp_path, monkeypatch):
    t = world["port"]
    monkeypatch.setitem(t.cfg, "profile_infer", True)
    monkeypatch.setattr(Timer, "totals", {})
    out = str(tmp_path / "a.wav")
    wav, info = t.synthesize(TEXTS[0], seed=1, out_wav=out)
    back, sr = load_wav(out)
    assert sr == 22050 and back.shape == wav.shape
    np.testing.assert_allclose(back, np.clip(wav, -1, 1), atol=1e-4)
    assert set(Timer.totals) == {"front_end", "acoustic", "vocoder"}
    again, _ = t.synthesize(TEXTS[0], seed=1)
    np.testing.assert_array_equal(again, wav)


def test_fixed_sandhi_replaces_the_jieba_engine(world):
    t = world["port"]
    norm = t.g2p.preprocess(TEXTS[1])
    want = t._prepare(TEXTS[1])
    fixed = FixedSandhi({norm: t.sandhi.process_sandhi(norm, None)})
    engine, t.sandhi = t.sandhi, fixed
    try:
        _assert_same(t._prepare(TEXTS[1]), want)
        with pytest.raises(KeyError, match="no precomputed sandhi"):
            t._prepare(TEXTS[0])
    finally:
        t.sandhi = engine


def test_inferencer_defaults_to_cuda_and_raises_without_a_card(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tinfer.DictTTSInferencer(world["cfg"])


def test_vocoder_spec2wav_f32_and_bf16(world, jax_results):
    """f32 against the JAX vocoder, on the acoustic model's mels padded as
    synthesize_batch pads them (the shape the JAX vocoder has compiled),
    atol 2e-4 as for the wavs above; bf16 within 5 % of the f32 signal's
    rms (tests/test_hifigan.py's bound for the JAX class's bf16)."""
    infos = [info for _, info in jax_results[False]]
    n_max = max(i["n_frames"] for i in infos)
    t_crop = min(shape_bucket(n_max, 64), MAX_FRAMES)
    mel = np.full((len(infos), t_crop, 80), -6.0, np.float32)
    for b, i in enumerate(infos):
        mel[b, :i["n_frames"]] = i["mel"]
    cfg = dict(VOC, hop_size=HOP)
    state = world["port"].vocoder.generator.state_dict()
    w32 = HifiGanVocoder(cfg, params=state, device="cpu").spec2wav(mel)
    np.testing.assert_allclose(w32, world["vocoder"].spec2wav(mel), atol=2e-4)
    np.testing.assert_allclose(HifiGanVocoder(cfg, params=state, device="cpu").spec2wav(mel[0]), w32[0],
                               atol=1e-4)  # one row alone: other convolution algorithms
    voc16 = HifiGanVocoder({**cfg, "vocoder_infer_dtype": "bfloat16"}, params=state, device="cpu")
    assert voc16.generator.conv_pre.weight.dtype == torch.bfloat16
    w16 = voc16.spec2wav(torch.tensor(mel))
    assert w16.dtype == np.float32 and w16.shape == w32.shape == (len(infos), t_crop * HOP)
    rms = np.sqrt((w32 ** 2).mean())
    assert 0 < np.sqrt(((w16 - w32) ** 2).mean()) < 0.05 * rms


def test_vocoder_registry_checkpoint_and_seeded_init(tmp_path):
    from dicttts_tpu_torch.utils.checkpoint import save_checkpoint

    assert get_vocoder_cls("HifiGanVocoder") is HifiGanVocoder
    assert get_vocoder_cls("hifiganvocoder") is HifiGanVocoder
    assert get_vocoder_cls("dicttts_tpu_torch.vocoders.hifigan.HifiGanVocoder") is HifiGanVocoder
    cfg = dict(VOC, vocoder_ckpt=str(tmp_path / "voc"))
    a, b = HifiGanVocoder(cfg, device="cpu"), HifiGanVocoder(cfg, device="cpu", seed=0)
    assert all(torch.equal(x, y) for x, y in zip(a.generator.parameters(), b.generator.parameters()))
    other = {k: v + 1 for k, v in a.generator.state_dict().items()}
    save_checkpoint(cfg["vocoder_ckpt"], 5, {"params_g": other})
    c = HifiGanVocoder(cfg, device="cpu")
    assert all(torch.equal(c.generator.state_dict()[k], v) for k, v in other.items())
    with pytest.raises(ValueError, match="vocoder_infer_dtype"):
        HifiGanVocoder(dict(VOC, vocoder_infer_dtype="float16"), device="cpu")


def test_mel_ops_and_wav2spec_match_jax(tmp_path):
    from dicttts_tpu.vocoders.hifigan import save_wav as jsave

    rng = np.random.RandomState(2)
    wav = (np.sin(np.arange(9000) * 0.05) * 0.5 + rng.randn(9000) * 0.05).astype(np.float32)
    batch = np.stack([wav, wav[::-1].copy()])
    t, j = torch.from_numpy(batch), jnp.asarray(batch)
    np.testing.assert_allclose(tmel.log10_mel(t).numpy(), np.asarray(jmel.log10_mel(j)), atol=1e-4)
    np.testing.assert_allclose(tmel.batched_log10_mel(t).numpy(), np.asarray(jmel.batched_log10_mel(j)),
                               atol=1e-4)
    np.testing.assert_allclose(tmel.gan_log_mel(t).numpy(), np.asarray(jmel.gan_log_mel(j)), atol=2e-4)
    for center, mode in ((True, "constant"), (True, "reflect"), (False, "constant")):
        np.testing.assert_allclose(
            tmel.stft_magnitude(t, 512, 128, 400, center, mode).numpy(),
            np.asarray(jmel.stft_magnitude(j, 512, 128, 400, center, mode)), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tmel.hann_window(1024), jmel.hann_window(1024))
    np.testing.assert_array_equal(tmel.mel_filterbank(22050, 1024, 80, 80.0, 7600.0),
                                  jmel.mel_filterbank(22050, 1024, 80, 80.0, 7600.0))
    assert tmel.librosa_pad_lr(9000, 1024, 256) == jmel.librosa_pad_lr(9000, 1024, 256)
    path = str(tmp_path / "w.wav")
    jsave(path, wav)
    for src in (path, wav):
        w_t, m_t = HifiGanVocoder.wav2spec(src)
        w_j, m_j = JVocoder.wav2spec(src)
        np.testing.assert_array_equal(w_t, w_j)
        np.testing.assert_allclose(m_t, m_j, atol=1e-4)


def test_mulaw_matches_jax():
    x = np.concatenate([np.linspace(-1.2, 1.2, 4001), [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    u = tpcm.mulaw_encode(torch.from_numpy(x))
    assert u.dtype == torch.uint8
    np.testing.assert_array_equal(u.numpy(), np.asarray(jpcm.mulaw_encode(jnp.asarray(x))))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_allclose(tpcm.mulaw_decode(torch.from_numpy(codes)).numpy(),
                               np.asarray(jpcm.mulaw_decode(jnp.asarray(codes))), atol=1e-6)


def _imports(path):
    """Every module name a file imports, at any depth (lazy imports too),
    and every literal name given to importlib.import_module."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    names = []
    for node in ast.walk(ast.parse(src, path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    names += re.findall(r"import_module\(\s*['\"]([\w.]+)['\"]", src)
    return names


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted(glob.glob(os.path.join(ROOT, "dicttts_tpu_torch", "**", "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 40
    bad = [(os.path.relpath(f, ROOT), n) for f in files for n in _imports(f)
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dicttts_tpu")]
    assert bad == []
