"""K2, the S2PA bank backward, and its autograd function in the port,
against the JAX package: the plain version against the Pallas ``_bwd_call``
(interpret mode on the CPU) and against ``jax.grad`` through
``s2pa_bank_attend`` and through the XLA gather+einsum reference;
DictEncoder gradients in bank mode against
``jax.grad`` of the JAX module; the bank branch's sense remap under a
dropout mask against the JAX eager branch given the same mask. The CUDA
kernel against the plain version on the card: test_torch_kernels_gpu.py.

On a slot whose gloss tokens are all masked the weights are uniform and do
not depend on qe, so the gradient is 0: the port's K2 gives 0, as
``jax.grad`` of the XLA reference does, while the Pallas backward does
not (it leaves d_logits unmasked). Those slots are held to the XLA
reference; every other slot to the Pallas kernel.

Tolerances:
- K2, f32: rtol/atol 2e-4 (the JAX package's own for this backward,
  tests/test_s2pa_bank_fused.py). bf16: atol 2**-7 * max|d_qe|, two bf16
  ulps, because d_logits and d_qe are rounded to bf16 and an f32 last-bit
  difference can flip a rounding.
- DictEncoder gradients: rtol 5e-4 / atol 5e-5 (the JAX package's own for
  the bank-mode module gradients).
- S2PA forward under a mask: atol 2e-5 (f32, summation order only).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dicttts_tpu.models import dict_encoder as jde
from dicttts_tpu.models.dict_encoder import S2PA_MASK_VALUE
from dicttts_tpu.ops.s2pa_bank_pallas import _bwd_call, s2pa_bank_attend as jax_attend
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params
from dicttts_tpu_torch.models import dict_encoder as tde
from dicttts_tpu_torch.ops.s2pa_bank import (s2pa_bank_attend, s2pa_bank_bwd, s2pa_bank_bwd_plain,
                                             s2pa_bank_fwd, s2pa_bank_fwd_plain)

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

V, L, E = 24, 16, 128


def _inputs(seed=0, N=21):  # N not a multiple of any tile
    rng = np.random.RandomState(seed)
    bank = (rng.randn(V, L, E) * 0.3).astype(np.float32)
    wt = rng.randint(0, V, (N,)).astype(np.int32)
    qe = (rng.randn(N, E) * 0.2).astype(np.float32)
    km_bank = (rng.randint(0, 4, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    km_bank[3] = 0  # an all-masked word row
    wt[0] = 3
    mask = ((rng.rand(N, L) > 0.1) / 0.9).astype(np.float32)
    g_ctx = rng.randn(N, E).astype(np.float32)
    g_w = rng.randn(N, L).astype(np.float32)
    return bank, wt, qe, km_bank[wt], mask, g_ctx, g_w


def _live(km):
    """Slots with at least one unmasked gloss token."""
    return (np.asarray(km) != 0).any(axis=1)


@pytest.mark.parametrize("N", [21, 1])
def test_bwd_plain_matches_pallas_f32(N):
    args = _inputs(0, N)
    live = _live(args[3])
    ref = np.asarray(_bwd_call(*map(jnp.asarray, args), interpret=True))
    got = s2pa_bank_bwd_plain(*map(torch.tensor, args)).numpy()
    assert not live[0]  # slot 0 is all-masked
    np.testing.assert_array_equal(got[~live], 0.0)
    np.testing.assert_allclose(got[live], ref[live], rtol=2e-4, atol=2e-4)


def test_bwd_plain_matches_pallas_bf16():
    bank, wt, qe, km, mask, g_ctx, g_w = _inputs(1)
    bf = ml_dtypes.bfloat16
    ref = _bwd_call(jnp.asarray(bank.astype(bf)), jnp.asarray(wt), jnp.asarray(qe.astype(bf)),
                    jnp.asarray(km), jnp.asarray(mask), jnp.asarray(g_ctx.astype(bf)),
                    jnp.asarray(g_w), interpret=True)
    ref = np.asarray(ref).astype(np.float32)
    got = s2pa_bank_bwd_plain(torch.tensor(bank).bfloat16(), torch.tensor(wt),
                              torch.tensor(qe).bfloat16(), torch.tensor(km), torch.tensor(mask),
                              torch.tensor(g_ctx).bfloat16(), torch.tensor(g_w))
    assert got.dtype == torch.bfloat16
    live = _live(km)
    got = got.float().numpy()
    np.testing.assert_array_equal(got[~live], 0.0)
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=2 ** -7 * np.abs(ref).max())


def _loss_torch(fwd, bank, wt, qe, km, mask):
    ctx, w = fwd(bank, wt, qe, km, mask)
    return (ctx ** 2).sum() + torch.sin(w).sum()


def _xla_ref(bank, wt, qe, km, mask):
    """The JAX package's gather+einsum reference (tests/test_s2pa_bank_fused.py)."""
    keys = bank[wt]
    logits = jnp.where(km != 0, jnp.einsum("nle,ne->nl", keys, qe), S2PA_MASK_VALUE)
    w = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("nl,nle->ne", w * mask, keys), w


def test_autograd_matches_jax_grad():
    bank, wt, qe, km, mask, _, _ = _inputs(2)
    jargs = [jnp.asarray(a) for a in (bank, wt, km, mask)]

    def loss_jax(fwd, q):
        b, w_, k, m = jargs
        ctx, w = fwd(b, w_, q, k, m)
        return jnp.sum(ctx ** 2) + jnp.sum(jnp.sin(w))

    ref_pallas = np.asarray(jax.grad(lambda q: loss_jax(
        lambda *a: jax_attend(*a, True), q))(jnp.asarray(qe)))
    ref_xla = np.asarray(jax.grad(lambda q: loss_jax(_xla_ref, q))(jnp.asarray(qe)))
    q = torch.tensor(qe, requires_grad=True)
    t_bank, t_wt, t_km, t_mask = map(torch.tensor, (bank, wt, km, mask))
    _loss_torch(s2pa_bank_attend, t_bank, t_wt, q, t_km, t_mask).backward()
    live = _live(km)
    np.testing.assert_allclose(q.grad.numpy(), ref_xla, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(q.grad.numpy()[live], ref_pallas[live], rtol=2e-4, atol=2e-4)


def test_autograd_matches_plain_forward_and_gives_bank_no_gradient():
    bank, wt, qe, km, mask, _, _ = _inputs(3)
    t_bank = torch.tensor(bank, requires_grad=True)
    t_mask = torch.tensor(mask, requires_grad=True)
    t_wt, t_km = torch.tensor(wt), torch.tensor(km)
    q1 = torch.tensor(qe, requires_grad=True)
    q2 = torch.tensor(qe, requires_grad=True)
    launches = (s2pa_bank_fwd.launches, s2pa_bank_bwd.launches)
    _loss_torch(s2pa_bank_attend, t_bank, t_wt, q1, t_km, t_mask).backward()
    assert (s2pa_bank_fwd.launches, s2pa_bank_bwd.launches) == launches  # CPU: plain versions
    assert t_bank.grad is None and t_mask.grad is None
    _loss_torch(s2pa_bank_fwd_plain, t_bank.detach(), t_wt, q2, t_km, t_mask.detach()).backward()
    torch.testing.assert_close(q1.grad, q2.grad, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", ["g_ctx_dtype", "g_ctx_shape", "g_w_dtype", "meta"])
def test_bwd_wrapper_rejects(bad):
    bank, wt, qe, km, mask, g_ctx, g_w = map(torch.tensor, _inputs(4))
    if bad == "g_ctx_dtype":
        g_ctx = g_ctx.double()
    elif bad == "g_ctx_shape":
        g_ctx = g_ctx[:, :-8]
    elif bad == "g_w_dtype":
        g_w = g_w.bfloat16()
    else:
        bank, wt, qe, km, mask, g_ctx, g_w = (t.to("meta") for t in (bank, wt, qe, km, mask, g_ctx, g_w))
    with pytest.raises((TypeError, ValueError)):
        s2pa_bank_bwd(bank, wt, qe, km, mask, g_ctx, g_w)


def _encoder_data(seed, B=2, T=5, P=4):
    rng = np.random.RandomState(seed)
    bank = (rng.randn(V, L, E) * 0.3).astype(np.float32)
    km_bank = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    pin_bank = rng.randint(1, 50, (V, P)).astype(np.int32)
    pm_bank = np.tile(np.array([1, 1, 2, 2], np.int32), (V, 1))
    wt = rng.randint(1, V, (B, T)).astype(np.int32)
    wt[1, 4:] = 0
    return bank, km_bank[wt], pin_bank[wt], pm_bank[wt], wt


def test_dict_encoder_bank_mode_gradients_match_jax():
    bank, km, pin, pm, wt = _encoder_data(5)
    jm = jde.DictEncoder(word_vocab=V, hidden_size=16, num_heads=2, dropout=0.0, pinyin_vocab=50)
    jbank = jnp.asarray(bank)
    dm_j = jde.DictMsg(jbank, jbank, jnp.asarray(km), jnp.asarray(pin), jnp.asarray(pm))
    params = jax.eval_shape(lambda r: jm.init(
        {"params": r}, jnp.asarray(wt), jde.DictMsg(jbank[wt], jbank[wt], *dm_j[2:]), None, True)["params"],
        jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s, r=np.random.RandomState(8): (r.randn(*s.shape) * 0.3).astype(np.float32),
                          params)

    def loss(p):
        x, _, pron_attn, _ = jm.apply({"params": p}, jnp.asarray(wt), dm_j, None, True)
        return jnp.sum(x ** 2) + jnp.sum(pron_attn ** 2)

    grads = jax_params_to_state(tde.DictEncoder(V, 16, pinyin_vocab=50, dict_embed_dim=E),
                                jax.device_get(jax.jit(jax.grad(loss))(params)))
    tm = load_jax_params(tde.DictEncoder(V, 16, pinyin_vocab=50, dict_embed_dim=E, dropout=0.0),
                         params).train()
    tbank = torch.tensor(bank)
    x, _, pron_attn, _ = tm(torch.tensor(wt), tde.DictMsg(tbank, tbank, *map(torch.tensor, (km, pin, pm))))
    ((x ** 2).sum() + (pron_attn ** 2).sum()).backward()
    named = dict(tm.named_parameters())
    assert set(named) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), np.asarray(g), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


def test_bank_branch_remaps_dropped_weights_like_jax_eager(monkeypatch):
    """Under a non-unit dropout mask the bank branch (K1/K2 path) gives what
    the JAX eager branch gives with the same mask: context, weights, pron
    and the sense remap of weights * mask."""
    bank, km, pin, pm, wt = _encoder_data(6)
    B, T = wt.shape
    H, p = 16, 0.1
    rng = np.random.RandomState(7)
    x = rng.randn(B, T, H).astype(np.float32)
    keep = rng.rand(B, T, L) >= p
    pron_mod = np.zeros((B, T), np.int32)
    pron_mod[0, 2] = 1

    jm = jde.S2PAAttention(H, pinyin_vocab=50, dropout_rate=p)
    keys = jnp.asarray(bank[wt])
    dm_j = jde.DictMsg(keys, keys, *map(jnp.asarray, (km, pin, pm)))
    params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x), dm_j)["params"]
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep))
    ref = jm.apply({"params": params}, jnp.asarray(x), dm_j, jnp.asarray(pron_mod), False,
                   rngs={"dropout": jax.random.PRNGKey(2)})

    monkeypatch.setattr(tde, "keep_mask", lambda shape, p_, gen, device: torch.tensor(
        keep.reshape(shape).astype(np.float32) / (1 - p_)))
    tm = load_jax_params(tde.S2PAAttention(H, E, 50, dropout_rate=p), params).train()
    tbank = torch.tensor(bank)
    out = tm(torch.tensor(x), tde.DictMsg(tbank, tbank, *map(torch.tensor, (km, pin, pm))),
             torch.tensor(pron_mod), word_tokens=torch.tensor(wt))
    assert not keep.all()
    for name, a, b in zip(("context", "weights", "pron", "pron_weights"), out, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-5, err_msg=name)
