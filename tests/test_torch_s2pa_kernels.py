"""The two S2PA kernels of the port: plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU), wrapper routing and
checks. The CUDA kernels against the plain versions on the card:
test_torch_kernels_gpu.py.

Tolerances:
- f32, K1: w atol 2e-6, ctx atol 2e-5 (the JAX package's own,
  tests/test_s2pa_bank_fused.py); K3: atol 1e-5 (tests/test_s2pa_pallas.py).
  Only summation orders differ.
- bf16 bank, K1: w atol 2e-6 (logits are f32 sums of exact bf16 products);
  ctx atol 2**-7 * max|ctx|, two bf16 ulps at the top of the range: the
  output is rounded to bf16, and w * mask is rounded to bf16 before the
  context sum, so a last-bit difference in an f32 sum can flip a rounding.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dicttts_tpu.ops.s2pa_bank_pallas import s2pa_bank_attend
from dicttts_tpu.ops.s2pa_pallas import s2pa_fused as jax_s2pa_fused
from dicttts_tpu_torch.ops import cuda_build
from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_fwd, s2pa_bank_fwd_plain
from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused, s2pa_fused_plain

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)


def _bank_inputs(seed=0, V=24, L=16, E=128, N=21):  # N not a multiple of any tile
    rng = np.random.RandomState(seed)
    bank = (rng.randn(V, L, E) * 0.3).astype(np.float32)
    wt = rng.randint(0, V, (N,)).astype(np.int32)
    qe = (rng.randn(N, E) * 0.2).astype(np.float32)
    km_bank = (rng.randint(0, 4, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    km_bank[3] = 0  # an all-masked word row
    wt[0] = 3
    km = km_bank[wt]
    mask = ((rng.rand(N, L) > 0.1) / 0.9).astype(np.float32)
    return bank, wt, qe, km, mask


def _fused_inputs(seed=0, B=2, T=5, L=16, H=32, P=8):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, T, H) * 0.1).astype(np.float32)
    k = (rng.randn(B, T, L, H) * 0.1).astype(np.float32)
    v = rng.randn(B, T, L, H).astype(np.float32)
    km = rng.randint(0, 4, (B, T, L)).astype(np.int32)
    km[:, :, 0] = 1
    km[0, 1] = 0  # an all-masked row
    pm = np.tile(np.array([1, 1, 2, 2, 3, 3, 0, 0], np.int32)[:P], (B, T, 1))
    return q, k, v, km, pm


def _torch(*arrays):
    return [torch.tensor(a) for a in arrays]


def test_bank_plain_matches_pallas_f32():
    bank, wt, qe, km, mask = _bank_inputs()
    ctx_j, w_j = s2pa_bank_attend(*map(jnp.asarray, (bank, wt, qe, km, mask)), True)
    ctx_t, w_t = s2pa_bank_fwd_plain(*_torch(bank, wt, qe, km, mask))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=2e-6)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=2e-5)
    np.testing.assert_allclose(w_t.numpy()[0], 1.0 / 16, atol=1e-7)  # all-masked: uniform


def test_bank_plain_matches_pallas_bf16():
    bank, wt, qe, km, mask = _bank_inputs(1)
    bank_b, qe_b = bank.astype(ml_dtypes.bfloat16), qe.astype(ml_dtypes.bfloat16)
    ctx_j, w_j = s2pa_bank_attend(jnp.asarray(bank_b), jnp.asarray(wt), jnp.asarray(qe_b),
                                  jnp.asarray(km), jnp.asarray(mask), True)
    ctx_t, w_t = s2pa_bank_fwd_plain(
        torch.tensor(bank).bfloat16(), torch.tensor(wt), torch.tensor(qe).bfloat16(),
        torch.tensor(km), torch.tensor(mask))
    assert ctx_t.dtype == torch.bfloat16 and w_t.dtype == torch.float32
    ctx_j = np.asarray(ctx_j).astype(np.float32)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=2e-6)
    np.testing.assert_allclose(ctx_t.float().numpy(), ctx_j, atol=2 ** -7 * np.abs(ctx_j).max())


def test_bank_wrapper_cpu_routes_to_plain():
    args = _torch(*_bank_inputs(2))
    before = s2pa_bank_fwd.launches
    ctx, w = s2pa_bank_fwd(*args)
    ctx_p, w_p = s2pa_bank_fwd_plain(*args)
    assert s2pa_bank_fwd.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(ctx, ctx_p, rtol=0, atol=0)
    torch.testing.assert_close(w, w_p, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["bank_dtype", "wt_dtype", "qe_dtype", "km_shape", "mask_dtype", "meta"])
def test_bank_wrapper_rejects(bad):
    bank, wt, qe, km, mask = _torch(*_bank_inputs(3))
    if bad == "bank_dtype":
        bank, qe = bank.half(), qe.half()
    elif bad == "wt_dtype":
        wt = wt.long()
    elif bad == "qe_dtype":
        qe = qe.double()
    elif bad == "km_shape":
        km = km[:, :-1]
    elif bad == "mask_dtype":
        mask = mask.bool()
    else:
        bank, wt, qe, km, mask = (t.to("meta") for t in (bank, wt, qe, km, mask))
    with pytest.raises((TypeError, ValueError)):
        s2pa_bank_fwd(bank, wt, qe, km, mask)


def test_fused_plain_matches_pallas():
    q, k, v, km, pm = _fused_inputs()
    ref = jax_s2pa_fused(*map(jnp.asarray, (q, k, v, km, pm)), tile_r=4, interpret=True)
    out = s2pa_fused_plain(*_torch(q, k, v, km, pm))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_fused_wrapper_odd_widths_and_cpu_route():
    # L=13 and P=6 take no lane padding in the port
    q, k, v, km, pm = _fused_inputs(1, B=1, T=3, L=13, P=6)
    ref = jax_s2pa_fused(*map(jnp.asarray, (q, k, v, km, pm)), tile_r=4, interpret=True)
    before = s2pa_fused.launches
    out = s2pa_fused(*_torch(q, k, v, km, pm))
    assert s2pa_fused.launches == before
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_fused_plain_matches_pallas_at_the_text_b1_geometry():
    """The text path's B=1 call (Tw bucketed to 16, L to 56, P to 8) at a
    narrow H: BOS and EOS rows with maps 1 over the utterance's widest gloss,
    words with glosses of 1-56 tokens and 1-3 senses, and the Tw-padding
    slots all-masked with pinyin_map 0."""
    rng = np.random.RandomState(6)
    T, L, H, P, n = 16, 56, 32, 8, 13  # 11 characters + BOS + EOS
    q = (rng.randn(1, T, H) / np.sqrt(H)).astype(np.float32)
    k = rng.randn(1, T, L, H).astype(np.float32)
    v = rng.randn(1, T, L, H).astype(np.float32)
    km = np.zeros((1, T, L), np.int32)
    pm = np.zeros((1, T, P), np.int32)
    glen = np.floor(rng.triangular(1, 1, 57, n - 2)).astype(int)
    glen[0] = L  # the widest gloss fills the bucket
    senses = rng.randint(1, 4, n - 2)
    km[0, [0, n - 1]] = 1
    pm[0, [0, n - 1], :2 * senses.max()] = 1
    for i, (g, ns) in enumerate(zip(glen, senses), 1):
        km[0, i, :g] = np.arange(g) * ns // g + 1
        pm[0, i, :2 * ns] = np.repeat(np.arange(1, ns + 1), 2)
    ref = jax_s2pa_fused(*map(jnp.asarray, (q, k, v, km, pm)), tile_r=8, interpret=True)
    out = s2pa_fused_plain(*_torch(q, k, v, km, pm))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    w, pron = out[1].numpy(), out[2].numpy()
    np.testing.assert_allclose(w[0, n:], 1.0 / L, atol=1e-7)  # pad slots: uniform over their own L
    assert (pron[0, n:] == 0).all()


@pytest.mark.parametrize("bad", ["k_shape", "km_dtype", "v_dtype", "meta"])
def test_fused_wrapper_rejects(bad):
    q, k, v, km, pm = _torch(*_fused_inputs(2))
    if bad == "k_shape":
        k = k[:, :, :, :-1]
    elif bad == "km_dtype":
        km = km.long()
    elif bad == "v_dtype":
        v = v.double()
    else:
        q, k, v, km, pm = (t.to("meta") for t in (q, k, v, km, pm))
    with pytest.raises((TypeError, ValueError)):
        s2pa_fused(q, k, v, km, pm)


def test_build_hash_follows_sources(tmp_path, monkeypatch):
    digest = cuda_build.source_digest()
    assert cuda_build.library_path().name == f"libdicttts_kernels_{digest}.so"
    for name in cuda_build.SOURCES + cuda_build.HEADERS:
        (tmp_path / name).write_bytes((cuda_build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    assert cuda_build.source_digest() == digest
    for name in (cuda_build.SOURCES[0], cuda_build.HEADERS[0]):
        with open(tmp_path / name, "a") as f:
            f.write("\n// edited\n")
        assert cuda_build.source_digest() != digest
        digest = cuda_build.source_digest()
