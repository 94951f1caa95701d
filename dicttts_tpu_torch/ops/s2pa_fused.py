"""Fused S2PA forward over gathered, projected keys and values (K3).

Replaces the Pallas TPU kernel ``s2pa_fused`` (``dicttts_tpu/ops/
s2pa_pallas.py``, ``_s2pa_kernel``) with the hand-written CUDA kernel
``csrc/s2pa_fused.cu``: logits, mask, softmax, context and the sense remap
onto pinyin slots in one pass per row.

What bounds it on the H100 is bytes: k and v are ``[N, L, H]`` f32 and each
element feeds one multiply-add. The kernel reads them once, by bulk async
copies into a ring of shared-memory stages issued at a CTA's start, and
keeps logits, weights and the ``[L, P]`` sense one-hot on the SM; at small
N it splits a row's L over a cluster of up to 8 CTAs. Unlike the TPU
kernel it takes any L and P, so no lane padding (``pad_dict_msg``) is done;
H must be a multiple of 4 (16-byte rows). ``fused_kernel_plan`` asks the
built library for the kernel's plan of a shape.

Under amp the JAX package calls its kernel with a bf16 q and f32 k and v,
computes in f32 and returns the outputs in q's dtype. So does this
wrapper: the kernel takes f32 only, so a lower-precision q is upcast
(exactly), the kernel runs unchanged, and ctx, w and pron are rounded to
q's dtype. The plain version does the same, with autocast off.

The kernel is the operator ``torch.ops.dicttts_tpu_torch.s2pa_fused``
(``torch.library.custom_op``), with the plain version as its CPU kernel,
the launch as its CUDA kernel and a fake kernel that gives the output
shapes and dtype, so ``torch.export`` keeps it as one node of the graph
(``serving_export.py``) on either device. A graph that holds it needs this
module imported to run or load. ``s2pa_fused``, the function callers call,
checks the inputs, upcasts a lower-precision q and calls the operator: for
CPU tensors that runs the plain version, for CUDA tensors the kernel; it
never falls back from one to the other. The operator has no backward:
K3 serves inference.
"""

from __future__ import annotations

import ctypes

import torch

from dicttts_tpu_torch.ops import cuda_build

MASK_VALUE = -1e9


def s2pa_fused_plain(q, k, v, key_map, pinyin_map):
    """Plain PyTorch version (mirror of ``s2pa_reference``)."""
    logits = torch.einsum("btlh,bth->btl", k, q)
    logits = torch.where(key_map != 0, logits, MASK_VALUE)
    w = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("btl,btlh->bth", w, v)
    same = (key_map[:, :, :, None] == pinyin_map[:, :, None, :]) & (pinyin_map[:, :, None, :] != 0)
    pron = torch.einsum("btl,btlp->btp", w, same.to(w.dtype))
    return ctx, w, pron


def _check(q, k, v, key_map, pinyin_map):
    if q.ndim != 3:
        raise ValueError(f"q must be [B, T, H], got {tuple(q.shape)}")
    B, T, H = q.shape
    if k.ndim != 4 or k.shape[:2] != (B, T) or k.shape[3] != H:
        raise ValueError(f"k must be [{B}, {T}, L, {H}], got {tuple(k.shape)}")
    L = k.shape[2]
    if v.shape != k.shape:
        raise ValueError(f"v must match k {tuple(k.shape)}, got {tuple(v.shape)}")
    if key_map.shape != (B, T, L) or key_map.dtype != torch.int32:
        raise ValueError(f"key_map must be [{B}, {T}, {L}] int32, got {tuple(key_map.shape)} {key_map.dtype}")
    if pinyin_map.ndim != 3 or pinyin_map.shape[:2] != (B, T) or pinyin_map.dtype != torch.int32:
        raise ValueError(f"pinyin_map must be [{B}, {T}, P] int32, got {tuple(pinyin_map.shape)} {pinyin_map.dtype}")
    if k.dtype != v.dtype or not (q.dtype == k.dtype or (q.is_floating_point() and k.dtype == torch.float32)):
        raise TypeError(f"q, k, v must share a dtype, or q be a float dtype with k and v float32: got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v, key_map, pinyin_map)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def fused_kernel_plan(N: int, L: int, H: int, P: int) -> dict:
    """K3's plan for N rows of [L, H] with P pinyin slots, from the kernel
    library (``choose_fused_plan`` in ``csrc/s2pa_fused.cu``, exported as
    ``s2pa_fused_plan``): the cluster size C over which a row's L is split,
    the CTAs launched, the tokens of one bulk copy, the ring's stages, the
    k tiles of a CTA's slice, threads and shared memory bytes a CTA. Needs
    the built library (nvcc). Raises ValueError for a shape the kernel does
    not take."""
    out, smem = (ctypes.c_int * 6)(), ctypes.c_longlong()
    ok = cuda_build.library().s2pa_fused_plan(N, L, H, P, out, ctypes.byref(smem))
    if not ok:
        raise ValueError(f"K3 does not take N={N}, L={L}, H={H}, P={P}: every axis must be non-empty, H a "
                         f"multiple of 4, and one CTA's shared memory at most 227 KB (got {smem.value} bytes)")
    keys = ("cluster", "ctas", "tile_tokens", "stages", "k_tiles", "threads")
    return {**dict(zip(keys, out)), "smem_bytes": smem.value}


def s2pa_fused(q, k, v, key_map, pinyin_map):
    """q: [B, T, H] (pre-scaled); k, v: [B, T, L, H]; key_map: [B, T, L]
    int32; pinyin_map: [B, T, P] int32 -> (ctx [B, T, H], w [B, T, L],
    pron [B, T, P]), all in q's dtype. q may be bf16 or f16 with k and v
    f32: it is upcast, and the outputs are rounded to its dtype."""
    _check(q, k, v, key_map, pinyin_map)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"s2pa_fused runs on cpu or cuda, not {q.device}")
    if q.dtype != k.dtype:
        return tuple(o.to(q.dtype) for o in s2pa_fused(q.to(k.dtype), k, v, key_map, pinyin_map))
    return tuple(torch.ops.dicttts_tpu_torch.s2pa_fused(q, k, v, key_map, pinyin_map))


s2pa_fused.launches = 0


@torch.library.custom_op("dicttts_tpu_torch::s2pa_fused", mutates_args=())
def s2pa_fused_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_map: torch.Tensor,
                  pinyin_map: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 as an operator, for inputs that ``s2pa_fused`` has checked (q,
    k and v of one dtype); its kernels follow."""
    raise ValueError(f"s2pa_fused runs on cpu or cuda, not {q.device}")


@s2pa_fused_op.register_kernel("cpu")
def _s2pa_fused_cpu(q, k, v, key_map, pinyin_map):
    with torch.autocast("cpu", enabled=False):
        return s2pa_fused_plain(q, k, v, key_map, pinyin_map)


@s2pa_fused_op.register_kernel("cuda")
def _s2pa_fused_cuda(q, k, v, key_map, pinyin_map):
    device = q.device
    if q.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {q.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, key_map, pinyin_map)):
        raise ValueError("s2pa_fused needs contiguous tensors")
    B, T, H = q.shape
    L, P = k.shape[2], pinyin_map.shape[2]
    if H % 4 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"s2pa_fused reads 16-byte rows: H must be a multiple of 4 (got {H}) and q, k, v "
                         f"16-byte aligned")
    N = B * T
    if N:
        fused_kernel_plan(N, L, H, P)  # raises for a shape the kernel does not take
    ctx = torch.empty_like(q)
    w = torch.empty((B, T, L), dtype=q.dtype, device=device)
    pron = torch.empty((B, T, P), dtype=q.dtype, device=device)
    if N:
        with torch.cuda.device(device):
            rc = cuda_build.library().s2pa_fused(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), key_map.data_ptr(), pinyin_map.data_ptr(),
                ctx.data_ptr(), w.data_ptr(), pron.data_ptr(), N, L, H, P,
                torch.cuda.current_stream(device).cuda_stream,
            )
        cuda_build.check_launch("s2pa_fused", rc)
        s2pa_fused.launches += 1
    return ctx, w, pron


@s2pa_fused_op.register_fake
def _s2pa_fused_fake(q, k, v, key_map, pinyin_map):
    B, T, _ = q.shape
    return (torch.empty_like(q), q.new_empty((B, T, k.shape[2])),
            q.new_empty((B, T, pinyin_map.shape[2])))
