"""Port parity of the PortaSpeech model (dicttts_tpu_torch.models.portaspeech
against dicttts_tpu.models.portaspeech), with the post-net Glow: training
mode given mel2word (mel_out, attn, dur, kl, z_p and the post-flow NLL),
inference with predicted durations, the FVAE prior sample and the Glow
sample, and the weight bridge both ways.

Both models get the same seeded random parameters (a flax tree loaded by
convert.portaspeech_state) and the same numpy noise: the JAX draws are
replaced by arrays chosen by shape (the FVAE's [B, T/4, latent], the Glow's
[B, T, 80]). mel2word is integer and must be equal. f32 on the CPU on both
sides: dur, attn, kl, postflow and mel_out atol 1e-4 (summation orders
only through ~30 layers, values O(1)); kl and postflow also rtol 1e-5.
The JAX model runs under ``jax.jit`` (~4 s to compile each mode, where
its eager run takes 11-19 s). The batch has an empty word, padded phones
and padded frames; at inference
every frame is compared, the padding frames' included, where the Glow
inverted under an all-ones mask carries their noise into the last real
frames (the JAX package's behaviour, kept).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models.portaspeech import PortaSpeech as JPortaSpeech
from dicttts_tpu.utils.torch_convert import (convert_duration_predictor, convert_fvae,
                                             convert_rel_encoder)
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models.portaspeech import PortaSpeech

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

NV, B, TPH, W, TM, M, MAX_FRAMES = 24, 2, 12, 5, 40, 8, 48
KW = dict(n_vocab=NV, hidden_size=16, num_heads=2, enc_layers=2, word_enc_layers=1,
          enc_ffn_kernel_size=3, dropout=0.0, dur_predictor_layers=2, dur_predictor_kernel=3,
          predictor_dropout=0.0, out_dims=M, latent_size=4, fvae_enc_dec_hidden=8,
          fvae_kernel_size=3, fvae_enc_n_layers=2, fvae_dec_n_layers=1, prior_flow_hidden=8,
          prior_flow_n_blocks=2, use_post_glow=True, post_glow_hidden=8, post_glow_n_blocks=4,
          post_glow_n_block_layers=2, share_wn_layers=2)


def _batch(seed):
    """Row 0: 5 words (word 3 has no phone), phones padded at the end;
    row 1: 3 words, shorter in phones and frames."""
    rng = np.random.RandomState(seed)
    ph2word = np.array([[1, 1, 2, 2, 2, 4, 5, 5, 5, 0, 0, 0],
                        [1, 2, 2, 3, 3, 3, 0, 0, 0, 0, 0, 0]], np.int32)
    tokens = np.where(ph2word > 0, rng.randint(1, NV, ph2word.shape), 0).astype(np.int32)
    mel2word = np.zeros((B, TM), np.int32)
    for b, durs in enumerate(([6, 9, 0, 7, 10], [8, 12, 8])):
        f = 0
        for w, d in enumerate(durs):
            mel2word[b, f:f + d] = w + 1
            f += d
    mels = (rng.randn(B, TM, M) * 0.5 - 1).astype(np.float32) * (mel2word > 0)[:, :, None]
    return tokens, ph2word, mel2word, mels


def _noises(seed):
    rng = np.random.RandomState(seed)
    return {(B, TM // 4, KW["latent_size"]): rng.randn(B, TM // 4, KW["latent_size"]),
            (B, MAX_FRAMES // 4, KW["latent_size"]): rng.randn(B, MAX_FRAMES // 4, KW["latent_size"]),
            (B, MAX_FRAMES, M): rng.randn(B, MAX_FRAMES, M)}


def _random_params(jm, seed):
    tokens, ph2word, mel2word, mels = _batch(0)
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        lambda r: jm.init({"params": r, "sample": r}, jnp.asarray(tokens), jnp.asarray(ph2word), W,
                          mel2word=jnp.asarray(mel2word), tgt_mels=jnp.asarray(mels))["params"],
        jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)
    for name in params["post_flow"]:  # flax's orthogonal init, columns scaled
        if name.startswith("invconv_"):
            q = np.linalg.qr(rng.randn(4, 4))[0] * [1.3, 0.8, 1.1, 0.9]
            params["post_flow"][name]["weight"] = q.astype(np.float32)
    return params


@pytest.fixture(scope="module")
def models():
    jm = JPortaSpeech(**KW)
    params = _random_params(jm, 1)
    tm = load_jax_params(PortaSpeech(**KW), params).eval()
    return jm, params, tm


def _jax_apply(monkeypatch, jm, noises, **kw):
    """``jm.apply`` under jax.jit, its normal draws replaced by ``noises``
    (chosen by shape), which reach the traced function as an argument."""
    cur = {}
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        cur["noises"][tuple(shape)].astype(dtype))

    def apply(params, tokens, ph2word, noise_arrays, mel2word=None, mels=None):
        cur["noises"] = noise_arrays
        return jm.apply({"params": params}, tokens, ph2word, W, mel2word=mel2word, tgt_mels=mels,
                        **kw, rngs={"sample": jax.random.PRNGKey(4)})

    return lambda params, tokens, ph2word, *inputs: jax.jit(apply)(
        params, tokens, ph2word, {k: jnp.asarray(v) for k, v in noises.items()}, *inputs)


def test_training_forward_matches_jax(models, monkeypatch):
    jm, params, tm = models
    tokens, ph2word, mel2word, mels = _batch(2)
    noises = _noises(3)
    apply = _jax_apply(monkeypatch, jm, noises)
    ref = apply(params, tokens, ph2word, mel2word, mels)
    with torch.no_grad():
        out = tm(torch.tensor(tokens), torch.tensor(ph2word), W, mel2word=torch.tensor(mel2word),
                 tgt_mels=torch.tensor(mels),
                 noise=torch.tensor(noises[(B, TM // 4, KW["latent_size"])], dtype=torch.float32))
    for key in ("dur", "attn", "mel_out", "z_p", "decoder_inp", "z_pf", "ldj_pf"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, err_msg=key)
    for key in ("kl", "postflow"):
        np.testing.assert_allclose(out[key].item(), float(ref[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    # frames of no word attend uniformly to their row's padding phones (word id 0 both)
    attn = out["attn"].numpy()
    for b in range(B):
        pad_ph = ph2word[b] == 0
        rows = attn[b][mel2word[b] == 0]
        np.testing.assert_allclose(rows[:, pad_ph], 1.0 / pad_ph.sum(), atol=1e-6)
        np.testing.assert_allclose(rows[:, ~pad_ph], 0.0, atol=1e-7)


def test_inference_with_the_glow_sample_matches_jax(models, monkeypatch):
    jm, params, tm = models
    tokens, ph2word, _, _ = _batch(5)
    noises = _noises(6)
    ref = _jax_apply(monkeypatch, jm, noises, infer=True, max_frames=MAX_FRAMES)(
        params, tokens, ph2word)
    with torch.no_grad():
        out = tm(torch.tensor(tokens), torch.tensor(ph2word), W, infer=True,
                 max_frames=MAX_FRAMES,
                 noise=torch.tensor(noises[(B, MAX_FRAMES // 4, KW["latent_size"])]).float(),
                 post_noise=torch.tensor(noises[(B, MAX_FRAMES, M)]).float())
    m2w = np.asarray(ref["mel2word"])
    np.testing.assert_array_equal(out["mel2word"].numpy(), m2w)
    n = (m2w > 0).sum(1)
    assert n.min() > 0 and n.max() < MAX_FRAMES, n  # real and padded frames both present
    for key in ("dur", "attn", "mel_out_fvae", "mel_out", "z_p"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, err_msg=key)
    assert not np.allclose(out["mel_out"].numpy(), out["mel_out_fvae"].numpy(), atol=1e-3)


def test_weight_bridge_round_trips_through_the_jax_converters(models):
    _, params, tm = models
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = {
        "ph_encoder": convert_rel_encoder(state, "ph_encoder.", KW["enc_layers"], 4, True),
        "dur_predictor": convert_duration_predictor(state, "dur_predictor.",
                                                    KW["dur_predictor_layers"]),
        # the converter's flow depths agree with the module only where they are equal
        "fvae": convert_fvae(state, "fvae.", 1, KW["fvae_enc_n_layers"], KW["fvae_dec_n_layers"],
                             4, KW["prior_flow_n_blocks"]),
    }
    for name, tree in back.items():
        flat_a = jax.tree_util.tree_flatten_with_path(params[name])[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert len(flat_a) == len(flat_b), name
        for path, leaf in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=f"{name}{path}")
    # every parameter of the port is loaded from the flax tree, and nothing else
    n_flax = len(jax.tree_util.tree_leaves(params))
    assert len(state) == n_flax
