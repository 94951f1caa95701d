"""Port parity: S2PAAttention (bank, fused and eager branches) and
DictEncoder of dicttts_tpu_torch against dicttts_tpu.models.dict_encoder.

The JAX bank branch runs the K1 Pallas kernel in interpret mode on the CPU;
its fused branch runs K3 with interpret=True (patched in as
tests/test_s2pa_pallas.py calls it). The port runs the kernels' plain
versions on the CPU.

Tolerances: f32 paths atol 2e-5 (summation order only; values O(1)). The
bf16 bank path also rounds q_e, w*mask and ctx_e to bf16 in both
frameworks; an f32 last-bit difference can flip one of those roundings, so
outputs are held to 2**-7 of their largest magnitude (two bf16 ulps).
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dicttts_tpu.models import dict_encoder as jde
from dicttts_tpu.ops import s2pa_pallas
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models import dict_encoder as tde

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

V, L, E, P, H, PINYIN = 40, 12, 32, 6, 32, 30
B, T = 2, 7


def _data(seed=0, all_masked_word=True):
    rng = np.random.RandomState(seed)
    bank = (rng.randn(V, L, E) * 0.5).astype(np.float32)
    km_bank = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    if all_masked_word:
        km_bank[5] = 0
    pin_bank = rng.randint(1, PINYIN, (V, P)).astype(np.int32)
    pm_bank = np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1))
    wt = rng.randint(1, V, (B, T)).astype(np.int32)
    wt[0, 2] = 5
    wt[1, 5:] = 0  # padded tail
    pron = np.zeros((B, T), np.int32)
    pron[0, 1], pron[1, 3] = 2, 1  # sandhi overrides
    return bank, km_bank, pin_bank, pm_bank, wt, pron


def _jax_msg(bank, km_bank, pin_bank, pm_bank, wt, gathered):
    keys = jnp.asarray(bank[wt] if gathered else bank)
    return jde.DictMsg(keys, keys, jnp.asarray(km_bank[wt]), jnp.asarray(pin_bank[wt]),
                       jnp.asarray(pm_bank[wt]))


def _torch_msg(bank, km_bank, pin_bank, pm_bank, wt, gathered, bank_dtype=torch.float32):
    keys = torch.tensor(bank[wt] if gathered else bank).to(bank_dtype)
    return tde.DictMsg(keys, keys, torch.tensor(km_bank[wt]), torch.tensor(pin_bank[wt]),
                       torch.tensor(pm_bank[wt]))


def _assert_outputs(outs_t, outs_j, atol=None, rel=None):
    for a, b in zip(outs_t, outs_j):
        b = np.asarray(b).astype(np.float32)
        tol = atol if rel is None else rel * np.abs(b).max()
        np.testing.assert_allclose(a.detach().float().numpy(), b, atol=tol)


@pytest.fixture
def fused_interpret(monkeypatch):
    monkeypatch.setattr(s2pa_pallas, "s2pa_fused",
                        functools.partial(s2pa_pallas.s2pa_fused, interpret=True))


def _s2pa_pair(seed, use_pallas=False, all_masked_word=True):
    rng = np.random.RandomState(seed + 100)
    x = rng.randn(B, T, H).astype(np.float32)
    data = _data(seed, all_masked_word)
    jm = jde.S2PAAttention(H, pinyin_vocab=PINYIN, dropout_rate=0.0, use_pallas=use_pallas)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), _jax_msg(*data[:5], True),
                     None, True, jnp.asarray(data[4]))["params"]
    params = jax.tree.map(np.asarray, params)
    tm = load_jax_params(tde.S2PAAttention(H, E, PINYIN, use_pallas), params)
    return x, data, jm, params, tm


@pytest.mark.parametrize("with_pron", [False, True])
def test_s2pa_eager_branch(with_pron):
    x, data, jm, params, tm = _s2pa_pair(0)
    pron = data[5] if with_pron else None
    ref = jm.apply({"params": params}, jnp.asarray(x), _jax_msg(*data[:5], True),
                   None if pron is None else jnp.asarray(pron), True, jnp.asarray(data[4]))
    out = tm(torch.tensor(x), _torch_msg(*data[:5], True),
             None if pron is None else torch.tensor(pron), torch.tensor(data[4]))
    _assert_outputs(out, ref, atol=2e-5)


@pytest.mark.parametrize("bank_dtype", ["float32", "bfloat16"])
def test_s2pa_bank_branch(bank_dtype):
    x, data, jm, params, tm = _s2pa_pair(1)
    bank = data[0]
    jbank = bank.astype(ml_dtypes.bfloat16) if bank_dtype == "bfloat16" else bank
    ref = jm.apply({"params": params}, jnp.asarray(x),
                   _jax_msg(jbank, *data[1:4], data[4], False), jnp.asarray(data[5]), True,
                   jnp.asarray(data[4]))
    out = tm(torch.tensor(x), _torch_msg(*data[:5], False, getattr(torch, bank_dtype)),
             torch.tensor(data[5]), torch.tensor(data[4]))
    if bank_dtype == "float32":
        _assert_outputs(out, ref, atol=2e-5)
    else:
        _assert_outputs(out, ref, rel=2 ** -7)


def test_s2pa_bank_branch_needs_one_bank():
    x, data, _, _, tm = _s2pa_pair(2)
    dm = _torch_msg(*data[:5], False)
    dm = dm._replace(values=dm.keys.clone())
    with pytest.raises(ValueError):
        tm(torch.tensor(x), dm, None, torch.tensor(data[4]))


def test_s2pa_fused_branch(fused_interpret):
    # no all-masked word here: the JAX kernel pads L to 128 lanes, so an
    # all-masked row gets weights 1/128 instead of 1/L (see the next test)
    x, data, jm, params, tm = _s2pa_pair(3, use_pallas=True, all_masked_word=False)
    ref = jm.apply({"params": params}, jnp.asarray(x), _jax_msg(*data[:5], True),
                   jnp.asarray(data[5]), True, jnp.asarray(data[4]))
    out = tm(torch.tensor(x), _torch_msg(*data[:5], True), torch.tensor(data[5]),
             torch.tensor(data[4]))
    _assert_outputs(out, ref, atol=2e-5)


def test_s2pa_fused_branch_all_masked_word_matches_eager(fused_interpret):
    """K3 takes any L, so an all-masked word gets uniform weights over its
    own L gloss slots, as the JAX eager branch and s2pa_reference give."""
    x, data, _, params, tm = _s2pa_pair(3, use_pallas=True)
    jm = jde.S2PAAttention(H, pinyin_vocab=PINYIN, dropout_rate=0.0, use_pallas=False)
    ref = jm.apply({"params": params}, jnp.asarray(x), _jax_msg(*data[:5], True),
                   jnp.asarray(data[5]), True, jnp.asarray(data[4]))
    out = tm(torch.tensor(x), _torch_msg(*data[:5], True), torch.tensor(data[5]),
             torch.tensor(data[4]))
    _assert_outputs(out, ref, atol=2e-5)
    np.testing.assert_allclose(out[1][0, 2].detach().numpy(), 1.0 / L, atol=1e-7)


def test_apply_pron_rule_and_sense_remap():
    rng = np.random.RandomState(4)
    w = rng.rand(B, T, L).astype(np.float32)
    data = _data(4)
    km, pm, pron = data[1][data[4]], data[3][data[4]], data[5]
    ref = jde.sense_remap(jnp.asarray(w), jnp.asarray(km), jnp.asarray(pm))
    out = tde.sense_remap(torch.tensor(w), torch.tensor(km), torch.tensor(pm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    ref2 = jde.apply_pron_rule(ref, jnp.asarray(pm), jnp.asarray(pron))
    out2 = tde.apply_pron_rule(out, torch.tensor(pm), torch.tensor(pron))
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), atol=1e-6)


@pytest.mark.parametrize("mode", ["bank", "eager", "fused"])
def test_dict_encoder(mode, fused_interpret):
    data = _data(5, all_masked_word=mode != "fused")
    jm = jde.DictEncoder(word_vocab=V, hidden_size=H, num_heads=2, ffn_kernel_size=5, dropout=0.0,
                         pinyin_vocab=PINYIN, use_pallas=mode == "fused")
    wt, pron = jnp.asarray(data[4]), jnp.asarray(data[5])
    params = jm.init({"params": jax.random.PRNGKey(5)}, wt, _jax_msg(*data[:5], True),
                     pron, True)["params"]
    params = jax.tree.map(np.asarray, params)
    gathered = mode != "bank"
    ref = jm.apply({"params": params}, wt, _jax_msg(*data[:5], gathered), pron, True)
    tm = load_jax_params(tde.DictEncoder(V, H, 2, 5, PINYIN, E, use_pallas=mode == "fused"), params)
    out = tm(torch.tensor(data[4]), _torch_msg(*data[:5], gathered), torch.tensor(data[5]))
    _assert_outputs(out, ref, atol=2e-5)
