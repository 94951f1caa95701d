"""Port parity: DictTTS at inference (dicttts_tpu_torch.models.dict_tts
against dicttts_tpu.models.dict_tts) and the weight bridge round trip.

Both models get the same seeded random parameters and the same numpy prior
noise (the JAX draw is replaced by it). mel2word is integer and must match
exactly; dur, pron_attn and mel_out are f32 through the whole stack on the
CPU, held to atol 1e-4 (summation order only, values O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models.dict_encoder import DictMsg as JMsg
from dicttts_tpu.models.dict_tts import DictTTS as JDictTTS
from dicttts_tpu.utils.torch_convert import convert_dict_tts
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models.dict_encoder import DictMsg
from dicttts_tpu_torch.models.dict_tts import DictTTS

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

V, L, E, P, PINYIN = 40, 10, 32, 6, 30
B, TW, MAX_FRAMES = 2, 8, 64
KW = dict(word_vocab=V, hidden_size=32, num_heads=2, enc_ffn_kernel_size=5, pinyin_vocab=PINYIN,
          dur_predictor_layers=2, dur_predictor_kernel=3, dur_predictor_chans=16,
          frames_multiple=4, out_dims=16, latent_size=4, fvae_enc_dec_hidden=16,
          fvae_kernel_size=5, fvae_enc_n_layers=2, fvae_dec_n_layers=2, prior_flow_hidden=8,
          prior_flow_kernel_size=3, prior_flow_n_blocks=4, fvae_strides=4)


def _data(seed):
    rng = np.random.RandomState(seed)
    bank = (rng.randn(V, L, E) * 0.5).astype(np.float32)
    km = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    pin = rng.randint(1, PINYIN, (V, P)).astype(np.int32)
    pm = np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1))
    wt = rng.randint(3, V, (B, TW)).astype(np.int32)
    wt[:, 0], wt[0, -1], wt[1, 5] = 1, 2, 2
    wt[1, 6:] = 0
    pron = np.zeros((B, TW), np.int32)
    pron[0, 3] = 2
    noise = rng.randn(B, MAX_FRAMES // 4, KW["latent_size"]).astype(np.float32)
    return bank, km, pin, pm, wt, pron, noise


def _random_params(init, seed):
    """Seeded random values in the shapes of a flax init (traced, not run)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)


def _jax_model(seed):
    bank, km, pin, pm, wt, pron, _ = _data(seed)
    jm = JDictTTS(dropout=0.0, predictor_dropout=0.0, **KW)
    keys = jnp.asarray(bank[wt])
    dm = JMsg(keys, keys, jnp.asarray(km[wt]), jnp.asarray(pin[wt]), jnp.asarray(pm[wt]))
    return jm, _random_params(
        lambda r: jm.init({"params": r, "sample": r}, jnp.asarray(wt), dm, jnp.asarray(pron),
                          mel2word=jnp.ones((B, 32), jnp.int32),
                          tgt_mels=jnp.zeros((B, 32, KW["out_dims"])))["params"], seed + 10)


@pytest.mark.parametrize("mode", ["bank", "gathered"])
def test_dict_tts_infer(mode, monkeypatch):
    seed = 0 if mode == "bank" else 1
    bank, km, pin, pm, wt, pron, noise = _data(seed)
    jm, params = _jax_model(seed)
    keys = bank if mode == "bank" else bank[wt]
    jkeys = jnp.asarray(keys)
    dm = JMsg(jkeys, jkeys, jnp.asarray(km[wt]), jnp.asarray(pin[wt]), jnp.asarray(pm[wt]))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    apply = jax.jit(lambda p, w, d, pr, r: jm.apply({"params": p}, w, d, pr, infer=True,
                                                      max_frames=MAX_FRAMES, rngs={"sample": r}))
    ref = apply(params, jnp.asarray(wt), dm, jnp.asarray(pron), jax.random.PRNGKey(2))

    tm = load_jax_params(DictTTS(dict_embed_dim=E, **KW), params).eval()
    tkeys = torch.tensor(keys)
    tdm = DictMsg(tkeys, tkeys, torch.tensor(km[wt]), torch.tensor(pin[wt]), torch.tensor(pm[wt]))
    with torch.no_grad():
        out = tm(torch.tensor(wt), tdm, torch.tensor(pron), max_frames=MAX_FRAMES,
                 noise=torch.tensor(noise))
    m2w = np.asarray(ref["mel2word"])
    np.testing.assert_array_equal(out["mel2word"].numpy(), m2w)
    n = (m2w > 0).sum(1)
    assert n.min() > 0 and n.max() < MAX_FRAMES, n  # real and padded frames both present
    for key in ("dur", "pron_attn", "mel_out", "z_p"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, err_msg=key)


def test_convert_round_trip_exact():
    """port state_dict -> the JAX package's convert_dict_tts -> the original
    flax tree, key for key and bit for bit."""
    _, params = _jax_model(2)
    tm = load_jax_params(DictTTS(dict_embed_dim=E, **KW), params)
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = convert_dict_tts(state, dur_predictor_layers=KW["dur_predictor_layers"], enc_n_layers=4,
                            fvae_enc_n_layers=KW["fvae_enc_n_layers"],
                            fvae_dec_n_layers=KW["fvae_dec_n_layers"],
                            prior_flow_n_blocks=KW["prior_flow_n_blocks"])
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))
