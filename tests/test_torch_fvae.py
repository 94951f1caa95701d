"""Port parity: duration predictor, WN, the prior flow in reverse and FVAE
infer of dicttts_tpu_torch against dicttts_tpu.models.

Parameters are flax-initialised and then replaced by seeded random values,
so zero-initialised layers (the flow's ``post`` conv) do real work. Both
frameworks get the same numpy prior noise: the JAX draw is replaced by it.
Tolerance atol 5e-5: f32 on the CPU, summation order only, through a few
dozen convolutions on O(1) values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models.duration import DurationPredictor as JDur
from dicttts_tpu.models.flows import ResidualCouplingBlock as JFlow
from dicttts_tpu.models.fvae import FVAE as JFVAE
from dicttts_tpu.models.wavenet import WN as JWN
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models.duration import DurationPredictor, out2dur
from dicttts_tpu_torch.models.flows import ResidualCouplingBlock
from dicttts_tpu_torch.models.fvae import FVAE
from dicttts_tpu_torch.models.wavenet import WN

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ATOL = 5e-5


def _randomize(params, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: (rng.randn(*np.shape(p)) * scale).astype(np.float32), params)


def _mask(B, T, cut):
    m = np.ones((B, T, 1), np.float32)
    m[1, cut:] = 0
    return m


def _np(x):
    return x.detach().numpy()


def test_duration_predictor_and_out2dur():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 24).astype(np.float32)
    nonpad = np.ones((2, 9), np.float32)
    nonpad[1, 6:] = 0
    jm = JDur(n_chans=16, n_layers=3, kernel_size=5, dropout_rate=0.0, softplus_out=True)
    p = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(nonpad))["params"], 1)
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(nonpad)))
    tm = load_jax_params(DurationPredictor(24, 16, 3, 5), p)
    out = tm(torch.tensor(x), torch.tensor(nonpad))
    np.testing.assert_allclose(_np(out), ref, atol=ATOL)
    # frame rounding: half to even in both, on exact .5 boundaries too
    log_dur = np.log(np.array([[0.5, 1.5, 2.5, 3.5, 1.0, 0.2, 7.49]], np.float32) + 1.0)
    np.testing.assert_array_equal(out2dur(torch.tensor(log_dur)).numpy(),
                                  np.asarray(JDur.out2dur(jnp.asarray(log_dur))))


@pytest.mark.parametrize("gin,dilation,with_mask", [(0, 1, False), (12, 1, True), (12, 2, True)])
def test_wn(gin, dilation, with_mask):
    rng = np.random.RandomState(2)
    B, T, Hc = 2, 13, 16
    x = rng.randn(B, T, Hc).astype(np.float32)
    g = rng.randn(B, T, gin).astype(np.float32) if gin else None
    mask = _mask(B, T, 9) if with_mask else None
    jm = JWN(Hc, 5, dilation, 3, gin)
    jargs = (jnp.asarray(x), None if mask is None else jnp.asarray(mask),
             None if g is None else jnp.asarray(g))
    p = _randomize(jm.init(jax.random.PRNGKey(1), *jargs)["params"], 3)
    ref = np.asarray(jm.apply({"params": p}, *jargs))
    tm = load_jax_params(WN(Hc, 5, dilation, 3, gin), p)
    out = tm(torch.tensor(x), None if mask is None else torch.tensor(mask),
             None if g is None else torch.tensor(g))
    np.testing.assert_allclose(_np(out), ref, atol=ATOL)


def test_prior_flow_reverse():
    rng = np.random.RandomState(4)
    B, T, C, gin = 2, 10, 4, 12
    z = rng.randn(B, T, C).astype(np.float32)
    g = rng.randn(B, T, gin).astype(np.float32)
    mask = _mask(B, T, 7)
    jm = JFlow(C, 8, 3, 1, 4, n_flows=3, gin_channels=gin)
    args = (jnp.asarray(z), jnp.asarray(mask), jnp.asarray(g))
    p = _randomize(jm.init(jax.random.PRNGKey(2), *args)["params"], 5)
    ref = np.asarray(jm.apply({"params": p}, *args, reverse=True))
    tm = load_jax_params(ResidualCouplingBlock(C, 8, 3, 1, 4, 3, gin), p)
    out = tm.reverse(torch.tensor(z), torch.tensor(mask), torch.tensor(g))
    np.testing.assert_allclose(_np(out), ref, atol=ATOL)


@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
def test_fvae_infer(noise_scale, monkeypatch):
    rng = np.random.RandomState(6)
    B, T, gin, latent, out_dims = 2, 24, 16, 4, 8
    g = rng.randn(B, T, gin).astype(np.float32)
    mask = _mask(B, T, 18)
    noise = rng.randn(B, T // 4, latent).astype(np.float32)
    kw = dict(in_out_channels=out_dims, hidden_channels=16, latent_size=latent, kernel_size=5,
              enc_n_layers=2, dec_n_layers=3, gin_channels=gin, strides=(4,),
              flow_hidden=8, flow_kernel_size=3, flow_n_steps=2)
    jm = JFVAE(**kw)
    x = rng.randn(B, T, out_dims).astype(np.float32)
    p = jm.init({"params": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)},
                jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))["params"]
    p = _randomize(p, 7)

    def fixed_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise, dtype)

    monkeypatch.setattr(jax.random, "normal", fixed_normal)
    ref_mel, ref_z = jm.apply({"params": p}, x_mask=jnp.asarray(mask), g=jnp.asarray(g), infer=True,
                              noise_scale=noise_scale, rngs={"sample": jax.random.PRNGKey(5)})
    tm = FVAE(out_dims, 16, latent, 5, 2, 3, gin, (4,), 8, 3, 2)
    load_jax_params(tm, p)
    mel, z = tm.infer(torch.tensor(g), torch.tensor(mask), torch.tensor(noise), noise_scale)
    np.testing.assert_allclose(_np(z), np.asarray(ref_z), atol=ATOL)
    np.testing.assert_allclose(_np(mel), np.asarray(ref_mel), atol=ATOL)
