"""Port parity: dicttts_tpu_torch.models.layers against
dicttts_tpu.models.layers (window_size=None, the DictEncoder's setting).

Same flax parameters, same numpy inputs. Tolerance atol 2e-5: both run in
f32 on the CPU; the only differences are summation orders in the matmuls,
convolutions and LayerNorm statistics (values are O(1))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models import layers as jl
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models import layers as tl

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ATOL = 2e-5


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _x(seed, B=2, T=9, C=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 6:] = 0
    return x, mask


def _t(a):
    return torch.tensor(np.asarray(a))


def test_layer_norm():
    x, _ = _x(0)
    m = jl.LayerNorm()
    p = _np_tree(m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    p = {"gamma": np.random.RandomState(1).randn(16).astype(np.float32), "beta": p["beta"] + 0.3}
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    ln = tl.LayerNorm(16)
    ln.load_state_dict({"gamma": _t(p["gamma"]), "beta": _t(p["beta"])})
    np.testing.assert_allclose(ln(_t(x)).detach().numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("kernel_size", [1, 5])
def test_conv_ffn(kernel_size):
    x, mask = _x(2)
    m = jl.ConvFFN(filter_channels=24, out_channels=16, kernel_size=kernel_size)
    p = _np_tree(m.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))["params"])
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)))
    ffn = tl.ConvFFN(16, 24, 16, kernel_size)
    ffn.load_state_dict({
        "conv_1.weight": _t(np.transpose(p["Conv_0"]["kernel"], (2, 1, 0))),
        "conv_1.bias": _t(p["Conv_0"]["bias"]),
        "conv_2.weight": _t(np.transpose(p["Conv_1"]["kernel"], (2, 1, 0))),
        "conv_2.bias": _t(p["Conv_1"]["bias"]),
    })
    out = ffn(_t(x), _t(mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_rel_multi_head_attention():
    x, mask = _x(3)
    attn_mask = mask[:, :, 0][:, None, :] * mask[:, :, 0][:, :, None]
    m = jl.RelMultiHeadAttention(16, 2, window_size=None)
    p = _np_tree(m.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(attn_mask))["params"])
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x), jnp.asarray(attn_mask)))
    a = tl.RelMultiHeadAttention(16, 2)
    state = {}
    for ours, theirs in (("q", "conv_q"), ("k", "conv_k"), ("v", "conv_v"), ("out", "conv_o")):
        state[f"{theirs}.weight"] = _t(p[ours]["kernel"].T[:, :, None])
        state[f"{theirs}.bias"] = _t(p[ours]["bias"])
    a.load_state_dict(state)
    out = a(_t(x), _t(attn_mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("n_layers,kernel_size,T", [(2, 5, 9), (2, 3, 1), (1, 5, 17)])
def test_rel_transformer_layers(n_layers, kernel_size, T):
    x, mask = _x(4 + n_layers, T=T, C=32)
    if T == 1:
        mask[:] = 1
    m = jl.RelTransformerLayers(32, 64, 2, n_layers, kernel_size, 0.0, window_size=None)
    p = _np_tree(m.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask))["params"])
    ref = np.asarray(m.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)))
    t = load_jax_params(tl.RelTransformerLayers(32, 64, 2, n_layers, kernel_size), p)
    out = t(_t(x), _t(mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
