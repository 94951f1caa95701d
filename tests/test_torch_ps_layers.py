"""Port parity of the layers PortaSpeech adds to the port
(dicttts_tpu_torch.models.layers, models/fft_blocks.py, ops/seq.py) against
the JAX package's: the relative-window band ops and windowed attention at
window 4 (T = 3, below window + 1, and T = 9), ConvReluNorm,
RelTransformerEncoder with its prenet, FFTBlocks with its sinusoid table,
and the four word helpers of ops/seq.py with an empty word and padded
rows.

Same seeded parameters (flax trees loaded through convert.py), same numpy
inputs, f32 on the CPU on both sides. Layer outputs atol 2e-5 (summation
orders only, values O(1)); the word pooling and duration sums atol 1e-6;
the band ops, the sinusoid table, the word masks and the intra-word
positions exactly; the converters' round trips bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models import fft_blocks as jfft
from dicttts_tpu.models import layers as jl
from dicttts_tpu.ops import seq as jseq
from dicttts_tpu.utils.torch_convert import convert_conv_relu_norm, convert_rel_encoder
from dicttts_tpu_torch.convert import attn_state, load_jax_params
from dicttts_tpu_torch.models import fft_blocks as tfft
from dicttts_tpu_torch.models import layers as tl
from dicttts_tpu_torch.ops import seq as tseq

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ATOL = 2e-5
C, W = 16, 4


def _random_params(init, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), shapes)


def _x(seed, T, B=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, max(T - 3, 1):] = 0
    return x, mask


def _tokens(seed, T, vocab=20):
    rng = np.random.RandomState(seed)
    tok = rng.randint(1, vocab, (2, T)).astype(np.int32)
    tok[1, max(T - 3, 1):] = 0
    return tok


def _assert_tree_equal(a, b):
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("T", [3, 9])
def test_band_ops_match_jax(T):
    rng = np.random.RandomState(T)
    band = rng.randn(2, 3, T, 2 * W + 1).astype(np.float32)
    full = rng.randn(2, 3, T, T).astype(np.float32)
    np.testing.assert_array_equal(tl.band_to_full(torch.tensor(band), T).numpy(),
                                  np.asarray(jl.band_to_full(jnp.asarray(band), T)))
    got = tl.full_to_band(torch.tensor(full), W).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.full_to_band(jnp.asarray(full), W)))
    # slots outside the sequence read 0, not a clipped neighbour
    for i in range(T):
        for m in range(2 * W + 1):
            j = i + m - W
            assert got[..., i, m].tolist() == (full[..., i, j].tolist() if 0 <= j < T
                                               else np.zeros((2, 3)).tolist())


@pytest.mark.parametrize("T", [3, 9])
def test_windowed_attention_matches_jax(T):
    x, mask = _x(1, T)
    attn_mask = mask[:, :, 0][:, None, :] * mask[:, :, 0][:, :, None]
    m = jl.RelMultiHeadAttention(C, 2, window_size=W)
    p = _random_params(lambda r: m.init(r, jnp.asarray(x), jnp.asarray(attn_mask))["params"], T)
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x), jnp.asarray(attn_mask)))
    a = tl.RelMultiHeadAttention(C, 2, window_size=W)
    state = {}
    attn_state(state, "", p)
    state.update(emb_rel_k=p["rel_k"], emb_rel_v=p["rel_v"])
    state = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    a.load_state_dict(state)
    out = a(torch.tensor(x), torch.tensor(attn_mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_conv_relu_norm_matches_jax():
    x, mask = _x(2, 9)
    m = jl.ConvReluNorm(C, C, kernel_size=5, n_layers=3)
    p = _random_params(lambda r: m.init(r, jnp.asarray(x), jnp.asarray(mask))["params"], 3)
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)))
    t = load_jax_params(tl.ConvReluNorm(C, C, C, 5, 3), p)
    np.testing.assert_allclose(t(torch.tensor(x), torch.tensor(mask)).detach().numpy(), ref,
                               atol=ATOL)
    state = {k: v.numpy() for k, v in t.state_dict().items()}
    _assert_tree_equal(p, convert_conv_relu_norm(state, "", 3))


@pytest.mark.parametrize("T", [3, 12])
def test_rel_transformer_encoder_matches_jax(T):
    tok = _tokens(4, T)
    m = jl.RelTransformerEncoder(20, C, 4 * C, 2, 2, kernel_size=5, window_size=W, prenet=True)
    p = _random_params(lambda r: m.init(r, jnp.asarray(tok))["params"], 5 + T)
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(tok)))
    t = load_jax_params(tl.RelTransformerEncoder(20, C, 4 * C, 2, 2, 5, window_size=W), p).eval()
    with torch.no_grad():
        np.testing.assert_allclose(t(torch.tensor(tok)).numpy(), ref, atol=ATOL)
    state = {k: v.numpy() for k, v in t.state_dict().items()}
    _assert_tree_equal(p, convert_rel_encoder(state, "", 2, W, True))


def test_position_table_is_built_once_and_matches_jax_at_every_length():
    first = tfft.position_table(30, 17, "cpu", offset=0)
    for length in (30, 5, 12, 48, 9):  # shorter views of one table, grown once
        got = tfft.position_table(length, 17, "cpu", offset=0)
        np.testing.assert_array_equal(got.numpy(), jfft.sinusoidal_positions(length, 17, 0))
    assert tfft.position_table(9, 17, "cpu", offset=0).untyped_storage().data_ptr() != (
        first.untyped_storage().data_ptr())
    assert tfft.position_table(48, 17, "cpu", offset=0).untyped_storage().data_ptr() == (
        tfft.position_table(3, 17, "cpu", offset=0).untyped_storage().data_ptr())
    np.testing.assert_array_equal(tfft.position_table(6, 17, "cpu").numpy(),
                                  jfft.sinusoidal_positions(6, 17))


def test_fft_blocks_and_sinusoid_table_match_jax():
    np.testing.assert_array_equal(tfft.sinusoidal_positions(40, 17, 0),
                                  jfft.sinusoidal_positions(40, 17, 0))
    x, mask = _x(6, 10)
    x = x * mask
    nonpad = mask[:, :, 0]
    m = jfft.FFTBlocks(C, 2, ffn_kernel_size=3, n_heads=2, dropout=0.0)
    p = _random_params(lambda r: m.init(r, jnp.asarray(x), jnp.asarray(nonpad))["params"], 7)
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x), jnp.asarray(nonpad)))
    t = load_jax_params(tfft.FFTBlocks(C, 2, 3, 2, 0.0), p)
    np.testing.assert_allclose(t(torch.tensor(x), torch.tensor(nonpad)).detach().numpy(), ref,
                               atol=ATOL)
    # nonpadding taken from |x| when not given
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    np.testing.assert_allclose(t(torch.tensor(x)).detach().numpy(), ref, atol=ATOL)


def _words():
    """ph2word with an empty word (3) in row 0 and padded phones in both rows."""
    ph2word = np.array([[1, 1, 2, 4, 4, 4, 0, 0], [1, 2, 2, 2, 3, 0, 0, 0]], np.int32)
    mel2word = np.array([[1, 1, 1, 2, 2, 4, 4, 4, 4, 0, 0, 0],
                         [1, 2, 2, 2, 2, 3, 3, 0, 0, 0, 0, 0]], np.int32)
    return ph2word, mel2word


def test_word_helpers_match_jax():
    ph2word, mel2word = _words()
    rng = np.random.RandomState(8)
    h = rng.randn(2, 8, C).astype(np.float32)
    dur = rng.rand(2, 8).astype(np.float32)
    n_words = 5
    got = tseq.group_hidden_by_segs(torch.tensor(h), torch.tensor(ph2word), n_words).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jseq.group_hidden_by_segs(jnp.asarray(h), jnp.asarray(ph2word), n_words)),
        atol=1e-6)
    assert not got[0, 2].any() and not got[0, 4].any() and not got[1, 3:].any()  # empty words: 0
    np.testing.assert_allclose(
        tseq.scatter_sum_by_segs(torch.tensor(dur), torch.tensor(ph2word), n_words).numpy(),
        np.asarray(jseq.scatter_sum_by_segs(jnp.asarray(dur), jnp.asarray(ph2word), n_words)),
        atol=1e-6)
    mask = tseq.build_word_mask(torch.tensor(mel2word), torch.tensor(ph2word))
    assert mask.dtype == torch.int32
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jseq.build_word_mask(jnp.asarray(mel2word), jnp.asarray(ph2word))))
    w2w = np.tile(np.arange(1, n_words + 1, dtype=np.int32), (2, 1))
    for x2word in (ph2word, mel2word):
        np.testing.assert_array_equal(
            tseq.intra_word_positions(torch.tensor(w2w), torch.tensor(x2word)).numpy(),
            np.asarray(jseq.intra_word_positions(jnp.asarray(w2w), jnp.asarray(x2word))))
