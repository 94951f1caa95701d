"""Port parity of the whole serving slice: DictTTSServer (word ids -> mel ->
wav) against the JAX package's DictTTSTask.test_step plus HifiGanVocoder
.spec2wav, with the crop and silence floor of
DictTTSInferencer.synthesize_batch (dicttts_tpu/infer.py:155-176).

Two modes: the device-resident bank (JAX: ``_const_dict_bank`` in the
state; port: K1's plain version) and gathered per-utterance banks with
``use_pallas_s2pa`` (JAX: K3 in interpret mode; port: K3's plain version).
The bank is f32 here so that both frameworks see the same S2PA inputs (the
bf16 bank path is held to the JAX kernel in test_torch_dict_encoder.py).
Same seeded parameters and the same numpy prior noise. mel2word, n_frames
and pinyin_pred must match exactly; mel_out and pron_attn atol 1e-4 and
the wavs atol 2e-4 (f32 on the CPU, summation order only, through the
acoustic model and then ~40 vocoder convolutions).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models.dict_encoder import DictMsg as JMsg
from dicttts_tpu.models.hifigan import HifiGanGenerator as JGen
from dicttts_tpu.ops import s2pa_pallas
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu.vocoders.hifigan import HifiGanVocoder
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.data.collate import shape_bucket
from dicttts_tpu_torch.models.dict_tts import DictTTS
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.serve import DictTTSServer, Request

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

V, L, E, P, PINYIN, MAX_FRAMES, LATENT = 40, 10, 32, 6, 30, 96, 4
VOC = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=128,
           resblock_kernel_sizes=(3, 7, 11))
CFG = dict(word_size=V, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dropout=0.0,
           value_embedding_size=PINYIN, dur_predictor_layers=2, dur_predictor_kernel=3,
           predictor_dropout=0.0, frames_multiple=4, latent_size=LATENT, fvae_enc_dec_hidden=16,
           fvae_kernel_size=5, fvae_enc_n_layers=1, fvae_dec_n_layers=2, prior_glow_hidden=8,
           glow_kernel_size=3, prior_glow_n_blocks=2, max_frames=MAX_FRAMES, dict_embed_dim=E,
           mel_disc_hidden_size=8, disc_win_num=1, hop_size=16, **VOC)


def _random_params(init, seed, scale):
    """Seeded random values in the shapes of a flax init (traced, not run)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), shapes)


def _bank(rng):
    km = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    km[:, 7:] = 0
    return {
        "keys": (rng.randn(V, L, E) * 0.5).astype(np.float32),
        "key_map": km,
        "pinyin": rng.randint(1, PINYIN, (V, P)).astype(np.int32),
        "pinyin_map": np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1)),
    }


def _requests(rng, gathered, bank):
    reqs = []
    for n, forced in ((9, (3, 2)), (5, None), (12, (6, 1))):
        ids = np.concatenate([[1], rng.randint(3, V, n - 2), [2]]).astype(np.int32)
        pron = np.zeros(n, np.int32)
        if forced:
            pron[forced[0]] = forced[1]
        rows = None
        if gathered:  # per-utterance rows, cut to this utterance's widest entry
            rows = {k: v[ids] for k, v in bank.items()}
            rows["keys"], rows["key_map"] = rows["keys"][:, :7], rows["key_map"][:, :7]
        reqs.append(Request(ids, pron, rows))
    return reqs


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    model = DictTTSTask(dict(CFG, use_pallas_s2pa=False)).model
    z = jnp.zeros
    dm = JMsg(z((1, 8, 8, E)), z((1, 8, 8, E)), z((1, 8, 8), jnp.int32), z((1, 8, 6), jnp.int32),
              z((1, 8, 6), jnp.int32))
    params_g = _random_params(
        lambda r: model.init({"params": r, "sample": r}, jnp.ones((1, 8), jnp.int32), dm,
                             z((1, 8), jnp.int32), mel2word=jnp.ones((1, 32), jnp.int32),
                             tgt_mels=z((1, 32, 80)))["params"], 1, 0.3)
    voc_params = _random_params(
        lambda r: JGen(**VOC).init(r, z((1, 16, 80)))["params"], 2, 0.2)
    acoustic = DictTTS(word_vocab=V, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3,
                       pinyin_vocab=PINYIN, dict_embed_dim=E, dur_predictor_layers=2,
                       dur_predictor_kernel=3, latent_size=LATENT, fvae_enc_dec_hidden=16,
                       fvae_enc_n_layers=1, fvae_dec_n_layers=2, prior_flow_hidden=8,
                       prior_flow_n_blocks=2, use_pallas_s2pa=True)
    bank = _bank(rng)
    server = DictTTSServer(load_jax_params(acoustic, params_g),
                           load_jax_params(HifiGanGenerator(**VOC), voc_params),
                           bank, max_frames=MAX_FRAMES, device="cpu")
    return dict(rng=rng, state={"params_g": params_g}, bank=bank, server=server,
                vocoder=HifiGanVocoder(dict(CFG), params=voc_params))


def _jax_batch(reqs, gathered):
    """infer.py::_collate for gathered banks; word ids only for the device bank."""
    B, Tw = len(reqs), shape_bucket(max(len(r.word_ids) for r in reqs), 8)
    batch = {"word_tokens": np.zeros((B, Tw), np.int32), "pron_modified": np.zeros((B, Tw), np.int32)}
    if gathered:
        Lb = shape_bucket(max(r.bank["keys"].shape[1] for r in reqs), 8)
        Pb = shape_bucket(max(r.bank["pinyin"].shape[1] for r in reqs), 4)
        batch.update(keys=np.zeros((B, Tw, Lb, E), np.float32),
                     key_map=np.zeros((B, Tw, Lb), np.int32),
                     pinyin=np.zeros((B, Tw, Pb), np.int32),
                     pinyin_map=np.zeros((B, Tw, Pb), np.int32))
    for b, r in enumerate(reqs):
        n = len(r.word_ids)
        batch["word_tokens"][b, :n] = r.word_ids
        batch["pron_modified"][b, :n] = r.pron_modified
        if gathered:
            for k in ("keys", "key_map", "pinyin", "pinyin_map"):
                batch[k][b, :n, :r.bank[k].shape[1]] = r.bank[k]
    if gathered:
        batch["values"] = batch["keys"]
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("mode", ["device_bank", "gathered"])
def test_serve_matches_test_step_and_spec2wav(world, mode, monkeypatch):
    gathered = mode == "gathered"
    reqs = _requests(world["rng"], gathered, world["bank"])
    task = DictTTSTask(dict(CFG, use_pallas_s2pa=gathered))
    state = dict(world["state"])
    if not gathered:
        state["_const_dict_bank"] = {k: jnp.asarray(v) for k, v in world["bank"].items()}
    batch = _jax_batch(reqs, gathered)
    noise = world["rng"].randn(len(reqs), MAX_FRAMES // 4, LATENT).astype(np.float32)
    monkeypatch.setattr(s2pa_pallas, "s2pa_fused",
                        functools.partial(s2pa_pallas.s2pa_fused, interpret=True))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    ref = jax.device_get(jax.jit(task.test_step)(state, batch, jax.random.PRNGKey(3)))
    monkeypatch.undo()

    # synthesize_batch's vocoder step (infer.py:155-176)
    n_frames = [int((ref["mel2word"][b] > 0).sum()) for b in range(len(reqs))]
    t_crop = min(shape_bucket(max(n_frames), 64), ref["mel_out"].shape[1])
    mel_b = ref["mel_out"][:, :t_crop].copy()
    for b, n in enumerate(n_frames):
        mel_b[b, n:] = -6.0
    wav_ref = world["vocoder"].spec2wav(mel_b)

    server = world["server"]
    out = server.acoustic_batch(reqs, noise=torch.tensor(noise))
    np.testing.assert_array_equal(out["mel2word"].numpy(), ref["mel2word"])
    np.testing.assert_array_equal(out["pinyin_pred"].numpy(), ref["pinyin_pred"])
    np.testing.assert_allclose(out["mel_out"].numpy(), ref["mel_out"], atol=1e-4)
    np.testing.assert_allclose(out["pron_attn"].numpy(), ref["pron_attn"], atol=1e-4)

    results = server.synthesize_batch(reqs, noise=torch.tensor(noise))
    assert 0 < min(n_frames) and max(n_frames) < MAX_FRAMES
    for b, (r, res) in enumerate(zip(reqs, results)):
        assert res.n_frames == n_frames[b]
        assert res.wav.shape == (n_frames[b] * 16,)
        np.testing.assert_allclose(res.wav, wav_ref[b, :n_frames[b] * 16], atol=2e-4)
        np.testing.assert_allclose(res.mel, ref["mel_out"][b, :n_frames[b]], atol=1e-4)
        np.testing.assert_array_equal(res.pinyin_pred, ref["pinyin_pred"][b, :len(r.word_ids)])


def test_serve_seeded_noise_and_checks(world):
    server = world["server"]
    reqs = _requests(np.random.RandomState(5), False, world["bank"])
    a = server.synthesize_batch(reqs, seed=7)
    b = server.synthesize_batch(reqs, seed=7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.wav, y.wav)
        assert np.isfinite(x.wav).all() and np.abs(x.wav).max() > 0
    bad = [Request(np.array([1, V + 3, 2], np.int32))]
    with pytest.raises(ValueError):
        server.synthesize_batch(bad)
    mixed = [reqs[0], _requests(np.random.RandomState(6), True, world["bank"])[0]]
    with pytest.raises(ValueError):
        server.synthesize_batch(mixed)


def test_serve_defaults_to_cuda_and_raises_without_a_card(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        DictTTSServer(world["server"].acoustic, world["server"].vocoder, world["bank"])
