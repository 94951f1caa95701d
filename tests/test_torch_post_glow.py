"""Port parity of the post-net Glow (dicttts_tpu_torch.models.post_glow
against dicttts_tpu.models.post_glow): forward (z and the log-det),
reverse, and the round trip, with sigmoid_scale off and on and
share_wn_layers 0 and 2; the shared WN stacks listed once in state_dict;
the InvConvNear interleave on its own; a length that is not a multiple of
n_sqz raises in both.

Same seeded flax parameters (loaded through convert.glow_state), same numpy
inputs, f32 on the CPU. z and the reverse atol 1e-4 (4 chained blocks of
affine couplings, values O(1)); the log-dets rtol 1e-5; the port's own
round trip back to its input atol 1e-4 on whole squeezed steps. The 1x1
mixing matrices are orthogonal with scaled columns (flax's init is
orthogonal): a random matrix's inverse would amplify rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models import post_glow as jpg
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models import post_glow as tpg

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

B, T, CIN, G = 2, 12, 8, 6
KW = dict(in_channels=CIN, hidden_channels=8, kernel_size=3, n_blocks=4, n_block_layers=2,
          n_split=4, n_sqz=2, gin_channels=G)


def _random_params(init, seed, scale=0.2):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), shapes)


def _well_conditioned(rng):
    """An orthogonal matrix (flax's init) with its columns scaled: a log-det
    away from 0, an inverse that amplifies no rounding."""
    return (np.linalg.qr(rng.randn(4, 4))[0] * [1.5, 0.8, 1.2, 0.7]).astype(np.float32)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, CIN).astype(np.float32)
    g = rng.randn(B, T, G).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 7:] = 0  # an odd length: the squeezed step over frames 6-7 is padding
    return x * mask, g, mask


def _pair(seed, **kw):
    x, g, mask = _inputs(seed)
    jm = jpg.Glow(**KW, **kw)
    params = _random_params(
        lambda r: jm.init(r, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))["params"], seed + 1)
    rng = np.random.RandomState(seed + 2)
    for name in params:
        if name.startswith("invconv_"):
            params[name]["weight"] = _well_conditioned(rng)
    tm = load_jax_params(tpg.Glow(**KW, **kw), params)
    return jm, params, tm, (x, g, mask)


@pytest.mark.parametrize("share", [0, 2])
@pytest.mark.parametrize("sigmoid_scale", [False, True])
def test_glow_forward_reverse_and_round_trip_match_jax(share, sigmoid_scale):
    jm, params, tm, (x, g, mask) = _pair(3 + share, share_wn_layers=share, sigmoid_scale=sigmoid_scale)
    j_in = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    z_ref, ld_ref = jm.apply({"params": params}, *j_in)
    t_in = (torch.tensor(x), torch.tensor(mask), torch.tensor(g))
    with torch.no_grad():
        z, ld = tm(*t_in)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=1e-4)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), rtol=1e-5)
        x_ref, ldr_ref = jm.apply({"params": params}, z_ref, j_in[1], j_in[2], reverse=True)
        x_back, ldr = tm(z, t_in[1], t_in[2], reverse=True)
    np.testing.assert_allclose(x_back.numpy(), np.asarray(x_ref), atol=1e-4)
    np.testing.assert_allclose(ldr.numpy(), np.asarray(ldr_ref), rtol=1e-5)
    # the flow inverts on whole squeezed steps; row 1's frame 6 shares a step with padding
    valid = np.repeat(mask[:, 1::2], 2, axis=1)
    np.testing.assert_allclose(x_back.numpy(), x * valid, atol=1e-4)
    np.testing.assert_allclose(ldr.numpy(), -ld.numpy(), rtol=1e-5)


def test_shared_wn_is_registered_once():
    tm = tpg.Glow(**KW, share_wn_layers=2)
    names = list(tm.state_dict())
    assert len(tm.shared_wn) == 2 and all(c.enc is None for c in tm.coupling)
    assert not any(".enc." in n for n in names)
    assert sum(n.startswith("shared_wn.0.") for n in names) == len(tm.shared_wn[0].state_dict())
    assert len(list(tm.parameters())) == len(names)  # no parameter reached twice
    own = tpg.Glow(**KW, share_wn_layers=0)
    assert len(own.shared_wn) == 0 and all(c.enc is not None for c in own.coupling)


def test_inv_conv_near_interleave_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(B, T, 16).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    w = _well_conditioned(rng)
    jm = jpg.InvConvNear(16, 4)
    conv = tpg.InvConvNear(16, 4)
    conv.weight.data = torch.tensor(w)
    for reverse in (False, True):
        y_ref, ld_ref = jm.apply({"params": {"weight": w}}, jnp.asarray(x), jnp.asarray(mask),
                                 reverse=reverse)
        y, ld = conv(torch.tensor(x), torch.tensor(mask), reverse=reverse)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-5)
        np.testing.assert_allclose(ld.detach().numpy(), np.asarray(ld_ref), rtol=1e-5)


def test_odd_length_raises_in_both():
    jm, params, tm, (x, g, mask) = _pair(5)
    with pytest.raises(ValueError, match="n_sqz"):
        jm.apply({"params": params}, jnp.asarray(x[:, :-1]))
    with pytest.raises(ValueError, match="n_sqz"):
        tm(torch.tensor(x[:, :-1]))
