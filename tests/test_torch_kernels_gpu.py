"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

Tolerances: f32 K1 w atol 2e-6 and ctx atol 2e-5, K3 atol 1e-5 (the JAX
package's own for these kernels), K3 under amp (bf16 q, outputs rounded
to bf16) one bf16 rounding, rtol 2**-7; bf16 K1 ctx atol 2**-7 * max|ctx|, two
bf16 ulps, because the output and w*mask are rounded to bf16 and an f32
last-bit difference can flip a rounding. K2 f32 d_qe atol 2e-5 * max|d_qe|
(summation order only); bf16 d_qe 2**-7 * max|d_qe| (d_logits and d_qe are
rounded to bf16). The autograd function's gradient against autograd
through the plain forward: rtol/atol 2e-4 (the JAX package's own).

K1 and K2 group the slots by word id and hold each row in the shared
memory of a cluster of CTAs, so the cases cover the grouping (uniform ids,
every slot the same id, Zipf ids: chunks of one, of many, and split
chunks), L not a multiple of the cluster size, the training geometry in
bf16, bitwise repeatability and an all-masked slot's zero gradient.

K3 splits a row's L over a cluster at small N, streams k and v through a
ring of stages when a slice does not fit, and serves several rows per CTA
when N exceeds what the card holds at once, so its cases are chosen by the
kernel's own plan (fused_kernel_plan) to cover each of those paths, with
all-masked rows, odd widths (L = 13, P = 6, H = 40) and a width past 1024.
"""

import numpy as np
import pytest
import torch

from dicttts_tpu_torch.ops.s2pa_bank import (s2pa_bank_attend, s2pa_bank_bwd, s2pa_bank_bwd_plain,
                                             s2pa_bank_fwd, s2pa_bank_fwd_plain)
from dicttts_tpu_torch.ops.s2pa_fused import fused_kernel_plan, s2pa_fused, s2pa_fused_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _word_ids(rng, V, N, ids):
    if ids == "same":
        return np.full(N, V // 2, np.int32)
    if ids == "zipf":  # P(rank k) ~ k ** -1.1 over the V words: a few take most slots
        p = np.arange(1, V + 1) ** -1.1
        return rng.permutation(V)[rng.choice(V, N, p=p / p.sum())].astype(np.int32)
    return rng.randint(0, V, (N,)).astype(np.int32)


def _bank_args(device, seed, V=24, L=16, E=128, N=21, dtype=torch.float32, ids="uniform"):
    rng = np.random.RandomState(seed)
    bank = torch.tensor(rng.randn(V, L, E).astype(np.float32) * 0.3)
    wt = torch.tensor(_word_ids(rng, V, N, ids))
    qe = torch.tensor(rng.randn(N, E).astype(np.float32) * 0.2)
    km = torch.tensor((rng.randint(0, 4, (N, L)) + (np.arange(L) == 0)).astype(np.int32))
    km[min(3, N - 1)] = 0  # an all-masked slot
    mask = torch.tensor(((rng.rand(N, L) > 0.1) / 0.9).astype(np.float32))
    return (bank.to(device, dtype), wt.to(device), qe.to(device, dtype), km.to(device), mask.to(device))


# (V, L, E, N); L = 97 and L = 7 are not multiples of the cluster size (4 in bf16, 8 in f32);
# E = 40 leaves the last CTAs of a cluster fewer output columns than the others, or none
SHAPES = [(24, 16, 128, 21), (50, 96, 768, 300), (5, 7, 8, 1), (50, 97, 768, 300), (9, 7, 8, 40),
          (12, 33, 40, 50)]
IDS = ["uniform", "same", "zipf"]


@pytest.mark.parametrize("ids", IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_bank_kernel_matches_plain(cuda, dtype, shape, ids):
    V, L, E, N = shape
    args = _bank_args(cuda, 0, V, L, E, N, dtype, ids)
    before = s2pa_bank_fwd.launches
    ctx, w = s2pa_bank_fwd(*args)
    torch.cuda.synchronize()
    assert s2pa_bank_fwd.launches == before + 1
    ctx_p, w_p = s2pa_bank_fwd_plain(*args)
    assert ctx.dtype == dtype and w.dtype == torch.float32
    torch.testing.assert_close(w, w_p, rtol=0, atol=2e-6)
    atol = 2e-5 if dtype == torch.float32 else 2 ** -7 * ctx_p.float().abs().max().item()
    torch.testing.assert_close(ctx.float(), ctx_p.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("ids", IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_bank_bwd_kernel_matches_plain(cuda, dtype, shape, ids):
    V, L, E, N = shape
    args = _bank_args(cuda, 4, V, L, E, N, dtype, ids)
    rng = np.random.RandomState(5)
    g_ctx = torch.tensor(rng.randn(N, E).astype(np.float32), device=cuda).to(dtype)
    g_w = torch.tensor(rng.randn(N, L).astype(np.float32), device=cuda)
    before = s2pa_bank_bwd.launches
    d_qe = s2pa_bank_bwd(*args, g_ctx, g_w)
    torch.cuda.synchronize()
    assert s2pa_bank_bwd.launches == before + 1
    ref = s2pa_bank_bwd_plain(*args, g_ctx, g_w).float()
    assert d_qe.dtype == dtype and torch.isfinite(d_qe.float()).all()
    scale = ref.abs().max().item()
    atol = 2e-5 * scale if dtype == torch.float32 else 2 ** -7 * scale
    torch.testing.assert_close(d_qe.float(), ref, rtol=0, atol=atol)
    assert (d_qe[min(3, N - 1)] == 0).all()  # the all-masked slot


def _training_args(device, dtype, ids="uniform"):
    """The training geometry: bank 8000 x 96 x 768, N = 60 x 64 slots."""
    args = _bank_args(device, 7, 8000, 96, 768, 3840, dtype, ids)
    rng = np.random.RandomState(8)
    g_ctx = torch.tensor(rng.randn(3840, 768).astype(np.float32), device=device).to(dtype)
    g_w = torch.tensor(rng.randn(3840, 96).astype(np.float32), device=device)
    return args, g_ctx, g_w


@pytest.mark.parametrize("ids", ["uniform", "zipf"])
def test_bank_kernels_at_the_training_geometry_bf16(cuda, ids):
    args, g_ctx, g_w = _training_args(cuda, torch.bfloat16, ids)
    ctx, w = s2pa_bank_fwd(*args)
    d_qe = s2pa_bank_bwd(*args, g_ctx, g_w)
    torch.cuda.synchronize()
    ctx_p, w_p = s2pa_bank_fwd_plain(*args)
    torch.testing.assert_close(w, w_p, rtol=0, atol=2e-6)
    torch.testing.assert_close(ctx.float(), ctx_p.float(), rtol=0,
                               atol=2 ** -7 * ctx_p.float().abs().max().item())
    del ctx_p, w_p
    ref = s2pa_bank_bwd_plain(*args, g_ctx, g_w).float()
    torch.testing.assert_close(d_qe.float(), ref, rtol=0, atol=2 ** -7 * ref.abs().max().item())
    assert (d_qe[3] == 0).all()  # the all-masked slot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bank_kernels_are_bitwise_repeatable(cuda, dtype):
    args = _bank_args(cuda, 9, 50, 97, 768, 600, dtype, "zipf")
    rng = np.random.RandomState(10)
    g_ctx = torch.tensor(rng.randn(600, 768).astype(np.float32), device=cuda).to(dtype)
    g_w = torch.tensor(rng.randn(600, 97).astype(np.float32), device=cuda)
    first = (*s2pa_bank_fwd(*args), s2pa_bank_bwd(*args, g_ctx, g_w))
    second = (*s2pa_bank_fwd(*args), s2pa_bank_bwd(*args, g_ctx, g_w))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bank_kernels_take_the_callers_slot_order(cuda):
    """The private entry the autograd function uses, with the slot order the
    forward saved, gives the public wrapper's bits; a malformed order is
    refused."""
    from dicttts_tpu_torch.ops.s2pa_bank import _bwd, _fwd, slot_order

    args = _bank_args(cuda, 11, 24, 16, 128, 200, torch.float32, "zipf")
    g_ctx = torch.randn(200, 128, device=cuda)
    g_w = torch.randn(200, 16, device=cuda)
    ids, order = slot_order(args[1])
    for a, b in zip(s2pa_bank_fwd(*args), _fwd(*args, (ids, order))):
        assert torch.equal(a, b)
    assert torch.equal(s2pa_bank_bwd(*args, g_ctx, g_w), _bwd(*args, g_ctx, g_w, (ids, order)))
    with pytest.raises(ValueError):
        _fwd(*args, (ids, order.int()))


@pytest.mark.parametrize("ids", ["uniform", "all_same", "zipf", "runs", "one"])
def test_bank_slot_chunks_partition_the_slots(cuda, ids):
    """The kernels' chunks (the library's rule): every slot in exactly one
    chunk, one word id per chunk, and a frequent word split into chunks of
    one fixed length, so it leaves no long serial tail."""
    from dicttts_tpu_torch.ops.s2pa_bank import bank_slot_chunks, slot_order

    rng = np.random.RandomState(3)
    N, Vw = 300, 50
    wt = {"uniform": rng.randint(0, Vw, N), "all_same": np.full(N, 7),
          "zipf": np.minimum(rng.zipf(1.1, N), Vw) - 1,
          "runs": np.repeat(np.arange(6), [1, 8, 9, 17, 30, 235]), "one": np.array([4])}[ids]
    sorted_ids, order = slot_order(torch.tensor(wt.astype(np.int32), device=cuda))
    starts, counts = bank_slot_chunks(sorted_ids)
    sorted_ids, order = sorted_ids.cpu(), order.cpu()
    assert int(counts.sum()) == len(wt)
    assert starts[0] == 0 and bool((counts >= 1).all())
    seen = torch.cat([order[s:s + c] for s, c in zip(starts.tolist(), counts.tolist())])
    assert sorted(seen.tolist()) == list(range(len(wt)))  # every slot exactly once
    for s, c in zip(starts.tolist(), counts.tolist()):
        assert len(set(sorted_ids[s:s + c].tolist())) == 1  # one row per chunk
    seg = int(bank_slot_chunks(torch.full((N,), 7, dtype=torch.int32))[1][0])
    assert 1 < seg < 16 and bool((counts <= seg).all())
    # a chunk ends only where the id changes or at a multiple of the split length
    ends = (starts + counts)[:-1]
    assert all(e % seg == 0 or sorted_ids[e] != sorted_ids[e - 1] for e in ends.tolist())
    distinct = len(np.unique(wt))
    assert distinct <= starts.numel() <= distinct + len(wt) // seg
    if ids == "all_same":  # one frequent word: split into full chunks, no long tail
        assert counts.tolist() == [seg] * (N // seg) + ([N % seg] if N % seg else [])


def test_bank_kernel_plan(cuda):
    from dicttts_tpu_torch.ops.s2pa_bank import bank_kernel_plan

    for dtype, C in ((torch.bfloat16, 4), (torch.float32, 8)):
        got_c, smem = bank_kernel_plan(96, 768, dtype)
        assert got_c == C
        assert 4 * (smem + 1024) <= 228 * 1024  # four CTAs an SM at the production shape
        slice_bytes = -(-96 // C) * 768 * (2 if dtype == torch.bfloat16 else 4)
        assert slice_bytes <= smem <= 227 * 1024
    assert bank_kernel_plan(7, 8, torch.bfloat16)[0] == 4  # L=7 over 4 CTAs: 2, 2, 2, 1
    assert bank_kernel_plan(97, 768, torch.float32)[0] == 8  # 13 a CTA, the last 6
    assert bank_kernel_plan(600, 768, torch.bfloat16)[0] == 8  # 150 tokens a CTA at 4: doubled
    for L, E in ((96, 12), (96, 1032), (2000, 1024), (1100, 8)):
        with pytest.raises(ValueError):
            bank_kernel_plan(L, E, torch.float32)


def test_bank_autograd_matches_plain_gradient(cuda):
    bank, wt, qe, km, mask = _bank_args(cuda, 6, 50, 96, 768, 301)

    def loss(fwd, q):
        ctx, w = fwd(bank, wt, q, km, mask)
        return (ctx ** 2).sum() + torch.sin(w).sum()

    q1 = qe.clone().requires_grad_(True)
    q2 = qe.clone().requires_grad_(True)
    before = (s2pa_bank_fwd.launches, s2pa_bank_bwd.launches)
    loss(s2pa_bank_attend, q1).backward()
    torch.cuda.synchronize()
    assert (s2pa_bank_fwd.launches, s2pa_bank_bwd.launches) == (before[0] + 1, before[1] + 1)
    loss(s2pa_bank_fwd_plain, q2).backward()
    torch.testing.assert_close(q1.grad, q2.grad, rtol=2e-4, atol=2e-4)


def test_bank_kernel_rejects_unaligned_width(cuda):
    with pytest.raises(ValueError):
        s2pa_bank_fwd(*_bank_args(cuda, 1, E=12))


@pytest.mark.parametrize("shape", [(2, 5, 16, 32, 8), (1, 3, 13, 192, 6), (16, 64, 96, 192, 8)])
def test_fused_kernel_matches_plain(cuda, shape):
    B, T, L, H, P = shape
    rng = np.random.RandomState(2)
    q = torch.tensor(rng.randn(B, T, H).astype(np.float32) * 0.1, device=cuda)
    k = torch.tensor(rng.randn(B, T, L, H).astype(np.float32) * 0.1, device=cuda)
    v = torch.tensor(rng.randn(B, T, L, H).astype(np.float32), device=cuda)
    km = rng.randint(0, 4, (B, T, L)).astype(np.int32)
    km[:, :, 0] = 1
    km[0, 0] = 0  # an all-masked row
    km = torch.tensor(km, device=cuda)
    pm = torch.tensor(np.tile(np.array([1, 1, 2, 2, 3, 3, 0, 0], np.int32)[:P], (B, T, 1)), device=cuda)
    before = s2pa_fused.launches
    out = s2pa_fused(q, k, v, km, pm)
    torch.cuda.synchronize()
    assert s2pa_fused.launches == before + 1
    for a, b in zip(out, s2pa_fused_plain(q, k, v, km, pm)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def _fused_args(device, seed, B, T, L, H, P, pad_rows=0):
    """K3 inputs: key_map in 0-3 with its first token 1, row (0, 0)
    all-masked, and the last ``pad_rows`` rows of each batch row all-masked
    with pinyin_map 0 (the text path's pad words); pinyin_map 1 1 2 2 3 3 0 0
    repeated over P."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, T, H) / np.sqrt(H)).astype(np.float32)
    k = rng.randn(B, T, L, H).astype(np.float32)
    v = rng.randn(B, T, L, H).astype(np.float32)
    km = rng.randint(0, 4, (B, T, L)).astype(np.int32)
    km[:, :, 0] = 1
    km[0, 0] = 0
    pm = np.tile(np.resize(np.array([1, 1, 2, 2, 3, 3, 0, 0], np.int32), P), (B, T, 1))
    if pad_rows:
        km[:, T - pad_rows:] = 0
        pm[:, T - pad_rows:] = 0
    return tuple(torch.tensor(a, device=device) for a in (q, k, v, km, pm))


# (B, T, L, H, P, pad rows, the plan's path): "cluster" splits a row's L over
# C > 1 CTAs, "stream" refills the ring within a row, "rows" serves several
# rows per CTA
FUSED_PATHS = [
    ((1, 32, 56, 192, 8, 4), "cluster"),   # the text path's B=1 geometry
    ((1, 32, 48, 192, 8, 4), "cluster"),   # its largest B=1 call in chip_smoke
    ((1, 16, 56, 192, 8, 3), "cluster"),
    ((1, 15, 13, 192, 6, 2), "cluster"),   # odd L and P
    ((2, 3, 7, 40, 5, 1), "cluster"),      # H = 40, P = 5: a padded [ctx | pron] column group
    ((4, 100, 200, 192, 8, 10), "stream"),
    ((1, 2, 6000, 192, 8, 0), "stream"),   # rows too long for a cluster's rings: one CTA a row
    ((4, 150, 96, 192, 8, 20), "rows"),    # N = 600: more rows than CTAs
    ((16, 32, 56, 192, 8, 6), "whole"),    # the text path's B=16 geometry: all of k issued at once
    ((1, 2, 3, 1032, 8, 0), "whole"),      # H past 1024: a thread owns several column groups
]


@pytest.mark.parametrize("shape, path", FUSED_PATHS)
def test_fused_kernel_paths_match_plain(cuda, shape, path):
    B, T, L, H, P, pad = shape
    plan = fused_kernel_plan(B * T, L, H, P)
    taken = {"cluster": plan["cluster"] > 1, "stream": plan["stages"] < 2 * plan["k_tiles"],
             "rows": plan["ctas"] < B * T * plan["cluster"], "whole": plan["stages"] >= plan["k_tiles"]}
    assert taken[path], plan
    args = _fused_args(cuda, 3, B, T, L, H, P, pad)
    before = s2pa_fused.launches
    out = s2pa_fused(*args)
    torch.cuda.synchronize()
    assert s2pa_fused.launches == before + 1
    ref = s2pa_fused_plain(*args)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    w = out[1]
    torch.testing.assert_close(w[0, 0], torch.full((L,), 1.0 / L, device=cuda), rtol=0, atol=1e-7)  # all-masked
    if pad:  # pad words: uniform weights over their own L, no pron
        torch.testing.assert_close(w[:, T - pad:], torch.full_like(w[:, T - pad:], 1.0 / L), rtol=0, atol=1e-7)
        assert (out[2][:, T - pad:] == 0).all()


@pytest.mark.parametrize("shape", [(1, 32, 56, 192, 8, 4), (16, 32, 56, 192, 8, 6)])
def test_fused_kernel_under_amp_matches_plain(cuda, shape):
    """A bf16 q with f32 k and v (the inference under amp): the kernel runs
    on q upcast and its outputs are rounded to bf16, equal to the plain
    version's f32 outputs rounded, to one bf16 rounding (K3's f32 atol 1e-5
    can flip a rounding)."""
    B, T, L, H, P, pad = shape
    q, k, v, km, pm = _fused_args(cuda, 6, B, T, L, H, P, pad)
    qb = q.to(torch.bfloat16)
    before = s2pa_fused.launches
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = s2pa_fused(qb, k, v, km, pm)
    torch.cuda.synchronize()
    assert s2pa_fused.launches == before + 1
    for a, b in zip(out, s2pa_fused_plain(qb.float(), k, v, km, pm)):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.to(torch.bfloat16).float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 32, 56, 192, 8), (16, 64, 96, 192, 8), (4, 100, 200, 192, 8)])
def test_fused_kernel_is_bitwise_repeatable(cuda, shape):
    args = _fused_args(cuda, 4, *shape)
    first = s2pa_fused(*args)
    second = s2pa_fused(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fused_kernel_rejects_unaligned_width(cuda):
    with pytest.raises(ValueError):  # H not a multiple of 4
        s2pa_fused(*_fused_args(cuda, 5, 1, 4, 8, 30, 8))
    q, k, v, km, pm = _fused_args(cuda, 5, 1, 4, 8, 32, 8)
    k_off = torch.empty(k.numel() + 1, device=cuda)[1:].view(k.shape)  # 4 bytes past an aligned address
    k_off.copy_(k)
    with pytest.raises(ValueError):
        s2pa_fused(q, k_off, v, km, pm)
    with pytest.raises(ValueError):
        fused_kernel_plan(4, 8, 30, 8)


def test_fused_kernel_plan(cuda):
    """The plan at the three measured shapes: B=1 text path (N = 32, L = 48,
    chip_smoke's largest B=1 call, and the bucket's L = 56) split over
    clusters of 8 (6 consumer warps and a producer warp a CTA) with every
    copy issued at once; B=16 text path
    (N = 512, L = 56) one CTA a row, four CTAs an SM, all of k issued at
    once; phase 3 (N = 1024, L = 96) 4 x 132 CTAs serving two rows each,
    streaming."""
    for L in (48, 56):
        b1 = fused_kernel_plan(32, L, 192, 8)
        assert (b1["cluster"], b1["ctas"], b1["threads"]) == (8, 256, 224)
        assert b1["stages"] == 2 * b1["k_tiles"]
    b16 = fused_kernel_plan(512, 56, 192, 8)
    assert (b16["cluster"], b16["ctas"]) == (1, 512)
    assert b16["stages"] >= b16["k_tiles"] and 4 * (b16["smem_bytes"] + 1024) <= 228 * 1024
    p3 = fused_kernel_plan(1024, 96, 192, 8)
    assert (p3["cluster"], p3["ctas"]) == (1, 4 * 132)
    assert p3["stages"] < 2 * p3["k_tiles"] and 4 * (p3["smem_bytes"] + 1024) <= 228 * 1024
    for shape in ((8, 1, 12284, 1), (1, 6142, 4, 8), (3, 6048, 192, 200)):  # the old kernel's limits
        assert fused_kernel_plan(*shape)["smem_bytes"] <= 227 * 1024
    for shape in ((192, 96, 192, 8), (2, 6000, 192, 8)):  # a cluster only where its slices fit whole
        plan = fused_kernel_plan(*shape)
        assert plan["cluster"] == 1 or plan["stages"] == 2 * plan["k_tiles"]
