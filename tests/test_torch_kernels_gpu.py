"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

Tolerances: f32 K1 w atol 2e-6 and ctx atol 2e-5, K3 atol 1e-5 (the JAX
package's own for these kernels); bf16 K1 ctx atol 2**-7 * max|ctx|, two
bf16 ulps, because the output and w*mask are rounded to bf16 and an f32
last-bit difference can flip a rounding. K2 f32 d_qe atol 2e-5 * max|d_qe|
(summation order only); bf16 d_qe 2**-7 * max|d_qe| (d_logits and d_qe are
rounded to bf16). The autograd function's gradient against autograd
through the plain forward: rtol/atol 2e-4 (the JAX package's own).
"""

import numpy as np
import pytest
import torch

from dicttts_tpu_torch.ops.s2pa_bank import (s2pa_bank_attend, s2pa_bank_bwd, s2pa_bank_bwd_plain,
                                             s2pa_bank_fwd, s2pa_bank_fwd_plain)
from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused, s2pa_fused_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank_args(device, seed, V=24, L=16, E=128, N=21, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    bank = torch.tensor(rng.randn(V, L, E).astype(np.float32) * 0.3)
    wt = torch.tensor(rng.randint(0, V, (N,)).astype(np.int32))
    qe = torch.tensor(rng.randn(N, E).astype(np.float32) * 0.2)
    km = torch.tensor((rng.randint(0, 4, (N, L)) + (np.arange(L) == 0)).astype(np.int32))
    km[min(3, N - 1)] = 0  # an all-masked slot
    mask = torch.tensor(((rng.rand(N, L) > 0.1) / 0.9).astype(np.float32))
    return (bank.to(device, dtype), wt.to(device), qe.to(device, dtype), km.to(device), mask.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(24, 16, 128, 21), (50, 96, 768, 300), (5, 7, 8, 1)])
def test_bank_kernel_matches_plain(cuda, dtype, shape):
    V, L, E, N = shape
    args = _bank_args(cuda, 0, V, L, E, N, dtype)
    before = s2pa_bank_fwd.launches
    ctx, w = s2pa_bank_fwd(*args)
    torch.cuda.synchronize()
    assert s2pa_bank_fwd.launches == before + 1
    ctx_p, w_p = s2pa_bank_fwd_plain(*args)
    assert ctx.dtype == dtype and w.dtype == torch.float32
    torch.testing.assert_close(w, w_p, rtol=0, atol=2e-6)
    atol = 2e-5 if dtype == torch.float32 else 2 ** -7 * ctx_p.float().abs().max().item()
    torch.testing.assert_close(ctx.float(), ctx_p.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(24, 16, 128, 21), (50, 96, 768, 300), (5, 7, 8, 1)])
def test_bank_bwd_kernel_matches_plain(cuda, dtype, shape):
    V, L, E, N = shape
    args = _bank_args(cuda, 4, V, L, E, N, dtype)
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
