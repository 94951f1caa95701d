"""S2PA attention over the un-gathered ``[V, L, E]`` dict bank: forward
(K1), backward (K2) and the autograd function that joins them.

Replaces the Pallas TPU kernel ``s2pa_bank_attend``
(``dicttts_tpu/ops/s2pa_bank_pallas.py``): its forward ``_fwd_call`` /
``_fwd_kernel`` with the hand-written CUDA kernel ``csrc/s2pa_bank_fwd.cu``,
and its backward ``_bwd_call`` / ``_bwd_kernel`` (wired by ``_attend_bwd``)
with ``csrc/s2pa_bank_bwd.cu``.

What bounds both on the H100 is bytes: each distinct word id's bank row
(147 KB in bf16, 295 KB in f32 at L=96, E=768) is used for 4*L*E (forward)
or 6*L*E (backward) flops per slot. Both kernels group the slots by word id
(``slot_order``, a stable sort that the forward computes and the
autograd function saves for the backward), and one cluster of C CTAs
holds a row in shared memory, split over its CTAs, while it serves every
slot of a chunk of up to 4 slots with that id: each distinct row is read
from device memory once, and the ``[B, Tw, L, E]`` gathered copy that the
plain versions build is never written. The sources
(``csrc/s2pa_common.cuh``) hold the layout and the grouping rule;
``bank_kernel_plan`` (cluster size and shared memory) and
``bank_slot_chunks`` (the chunks of slots) ask the built library for them.

``s2pa_bank_fwd`` and ``s2pa_bank_bwd`` take the plain version for CPU
tensors and launch the kernel for CUDA tensors; they never fall back from
one to the other. Each counts its launches with ``ops/launches.py``'s
``count_launch``, graph replays included.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dicttts_tpu_torch.ops import cuda_build
from dicttts_tpu_torch.ops.launches import count_launch

MASK_VALUE = -1e9
_BANK_DTYPES = (torch.bfloat16, torch.float32)


def bank_tensor(x, device) -> torch.Tensor:
    """A bank array as a contiguous tensor on ``device``, in the dtype it
    arrives in: a tensor, or a numpy array of any dtype, including the
    bfloat16 of the ``ml_dtypes`` package (which the JAX package's
    ``device_bank`` returns and ``torch.as_tensor`` refuses); that one is
    reinterpreted bit for bit, without importing ``ml_dtypes``."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
            x = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.as_tensor(a)
    return x.to(device).contiguous()


def slot_order(wt: torch.Tensor):
    """(ids [N] int32, order [N] int64): the word ids sorted stably and the
    slot each came from, so the kernels find the slots that share a bank row
    side by side. One sort on wt's device (no host sync)."""
    return torch.sort(wt, stable=True)


def bank_slot_chunks(ids: torch.Tensor):
    """The kernels' chunks of slots for ``ids, order = slot_order(wt)``:
    (starts, counts), int64 [n_chunks]; chunk c is the slots
    ``order[starts[c]:starts[c] + counts[c]]``, all with one word id, and one
    cluster serves it from one load of that id's bank row. Computed on the
    host by the kernel library's own rule (``starts_chunk`` in
    ``csrc/s2pa_common.cuh``, exported as ``s2pa_bank_chunks``), so it needs
    the built library (nvcc); for reports and tests, not the kernels' path."""
    ids_h = np.ascontiguousarray(ids.detach().cpu().numpy().astype(np.int32))
    counts = np.zeros_like(ids_h)
    cuda_build.library().s2pa_bank_chunks(ids_h.ctypes.data, ids_h.size, counts.ctypes.data)
    starts = np.flatnonzero(counts)
    return torch.from_numpy(starts), torch.from_numpy(counts[starts].astype(np.int64))


def bank_kernel_plan(L: int, E: int, dtype: torch.dtype) -> tuple[int, int]:
    """(C, shared memory bytes per CTA) of K1 and K2 for an [*, L, E] bank,
    from the kernel library (``choose_plan`` in ``csrc/s2pa_common.cuh``,
    exported as ``s2pa_bank_plan``): C = 4 CTAs per cluster in bf16 and 8 in
    f32, doubled up to 8 while a CTA would hold more than 128 gloss tokens or
    227 KB. Raises ValueError for a shape the kernels do not take."""
    C, smem = ctypes.c_int(), ctypes.c_longlong()
    ok = cuda_build.library().s2pa_bank_plan(L, E, int(dtype == torch.bfloat16), ctypes.byref(C),
                                             ctypes.byref(smem))
    if not ok:
        raise ValueError(f"the bank kernels do not take L={L}, E={E} in {dtype}: E must be a multiple "
                         f"of 8 and at most 1024, and a CTA of a cluster of at most 8 must hold at most "
                         f"128 gloss tokens in 227 KB of shared memory (got {smem.value} bytes at "
                         f"C={C.value})")
    return C.value, smem.value


def s2pa_bank_fwd_plain(bank, wt, qe, km, mask):
    """Plain PyTorch version: gather, f32 logits, finite mask, f32 softmax,
    weights*mask rounded to the bank dtype, f32 context in qe's dtype."""
    rows = bank[wt.long()].float()  # [N, L, E]
    logits = torch.einsum("nle,ne->nl", rows, qe.float())
    logits = torch.where(km != 0, logits, MASK_VALUE)
    w = torch.softmax(logits, dim=-1)
    wd = (w * mask).to(bank.dtype).float()
    ctx = torch.einsum("nl,nle->ne", wd, rows).to(qe.dtype)
    return ctx, w


def s2pa_bank_bwd_plain(bank, wt, qe, km, mask, g_ctx, g_w):
    """Plain PyTorch version of K2: recompute w from the gathered rows, then
    the softmax VJP; g_ctx and d_logits are rounded to the bank dtype before
    their products, as the TPU kernel does. d_logits is 0 where km == 0,
    since a masked logit is the constant -1e9: this changes only all-masked
    slots, where the TPU kernel's d_qe is not the gradient of its forward.
    Returns d_qe in qe's dtype."""
    rows = bank[wt.long()].float()  # [N, L, E]
    logits = torch.einsum("nle,ne->nl", rows, qe.float())
    w = torch.softmax(torch.where(km != 0, logits, MASK_VALUE), dim=-1)
    d_wd = torch.einsum("nle,ne->nl", rows, g_ctx.to(bank.dtype).float())
    d_w = d_wd * mask + g_w
    d_logits = torch.where(km != 0, w * (d_w - (w * d_w).sum(dim=-1, keepdim=True)), 0.0)
    return torch.einsum("nl,nle->ne", d_logits.to(bank.dtype).float(), rows).to(qe.dtype)


def _check(bank, wt, qe, km, mask):
    if bank.ndim != 3:
        raise ValueError(f"bank must be [V, L, E], got {tuple(bank.shape)}")
    _, L, E = bank.shape
    N = wt.shape[0]
    if bank.dtype not in _BANK_DTYPES:
        raise TypeError(f"bank dtype {bank.dtype} not in {_BANK_DTYPES}")
    if wt.ndim != 1 or wt.dtype != torch.int32:
        raise TypeError(f"wt must be [N] int32, got {tuple(wt.shape)} {wt.dtype}")
    if qe.shape != (N, E) or qe.dtype != bank.dtype:
        raise ValueError(f"qe must be [{N}, {E}] {bank.dtype}, got {tuple(qe.shape)} {qe.dtype}")
    if km.shape != (N, L) or km.dtype != torch.int32:
        raise ValueError(f"km must be [{N}, {L}] int32, got {tuple(km.shape)} {km.dtype}")
    if mask.shape != (N, L) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be [{N}, {L}] float32, got {tuple(mask.shape)} {mask.dtype}")
    devices = {t.device for t in (bank, wt, qe, km, mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _check_cuda(name, bank, wt, ids, order, tensors):
    """Raises for inputs the kernel does not take (see bank_kernel_plan)."""
    _, L, E = bank.shape
    bank_kernel_plan(L, E, bank.dtype)
    for t, dtype in ((ids, torch.int32), (order, torch.int64)):
        if t.shape != wt.shape or t.dtype != dtype or t.device != wt.device:
            raise ValueError(f"slots must be slot_order(wt): [{wt.shape[0]}] int32 and int64 on "
                             f"{wt.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    tensors = (*tensors, ids, order)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned tensors")


def s2pa_bank_fwd(bank, wt, qe, km, mask):
    """Gather-fused S2PA forward.

    bank: [V, L, E] bf16 or f32; wt: [N] int32 word ids in [0, V);
    qe: [N, E] query projected to bank space and scaled, in the bank dtype;
    km: [N, L] int32 gathered key_map (0 = masked gloss token);
    mask: [N, L] f32 keep-scale on the weights (ones at serving).
    Returns (ctx_e [N, E] in qe's dtype, w [N, L] f32 pre-mask weights).
    """
    return _fwd(bank, wt, qe, km, mask, None)


def _fwd(bank, wt, qe, km, mask, slots):
    """s2pa_bank_fwd; on the card with ``slots = slot_order(wt)`` if given
    (the autograd function, which saves them for K2, and chip_smoke's
    timing of the kernel alone), else computed here. The kernel reads the
    rows of ``slots``, never ``wt``: they must come from this wt."""
    _check(bank, wt, qe, km, mask)
    device = bank.device
    if device.type == "cpu":
        return s2pa_bank_fwd_plain(bank, wt, qe, km, mask)
    if device.type != "cuda":
        raise ValueError(f"s2pa_bank_fwd runs on cpu or cuda, not {device}")
    _, L, E = bank.shape
    N = wt.shape[0]
    ids, order = slot_order(wt) if slots is None else slots
    _check_cuda("s2pa_bank_fwd", bank, wt, ids, order, (bank, wt, qe, km, mask))
    ctx = torch.empty_like(qe)
    w = torch.empty((N, L), dtype=torch.float32, device=device)
    if N:
        with torch.cuda.device(device):
            rc = cuda_build.library().s2pa_bank_fwd(
                bank.data_ptr(), ids.data_ptr(), order.data_ptr(), qe.data_ptr(), km.data_ptr(),
                mask.data_ptr(), ctx.data_ptr(), w.data_ptr(), N, L, E,
                int(bank.dtype == torch.bfloat16), torch.cuda.current_stream(device).cuda_stream,
            )
        cuda_build.check_launch("s2pa_bank_fwd", rc)
        count_launch(s2pa_bank_fwd)
    return ctx, w


s2pa_bank_fwd.launches = s2pa_bank_fwd.captured = 0


def s2pa_bank_bwd(bank, wt, qe, km, mask, g_ctx, g_w):
    """Gather-fused S2PA backward: the gradient of ``s2pa_bank_fwd``'s
    (ctx_e, w) with respect to qe. Same inputs as the forward, plus
    g_ctx [N, E] in qe's dtype and g_w [N, L] f32. Returns d_qe [N, E] in
    qe's dtype; the bank gets no gradient (it is constant in training)."""
    return _bwd(bank, wt, qe, km, mask, g_ctx, g_w, None)


def _bwd(bank, wt, qe, km, mask, g_ctx, g_w, slots):
    """s2pa_bank_bwd; ``slots`` as in ``_fwd``."""
    _check(bank, wt, qe, km, mask)
    N, E = qe.shape
    if g_ctx.shape != (N, E) or g_ctx.dtype != qe.dtype:
        raise ValueError(f"g_ctx must be [{N}, {E}] {qe.dtype}, got {tuple(g_ctx.shape)} {g_ctx.dtype}")
    if g_w.shape != mask.shape or g_w.dtype != torch.float32:
        raise ValueError(f"g_w must be {tuple(mask.shape)} float32, got {tuple(g_w.shape)} {g_w.dtype}")
    device = bank.device
    if g_ctx.device != device or g_w.device != device:
        raise ValueError(f"gradients on {g_ctx.device}/{g_w.device}, inputs on {device}")
    if device.type == "cpu":
        return s2pa_bank_bwd_plain(bank, wt, qe, km, mask, g_ctx, g_w)
    if device.type != "cuda":
        raise ValueError(f"s2pa_bank_bwd runs on cpu or cuda, not {device}")
    L = bank.shape[1]
    ids, order = slot_order(wt) if slots is None else slots
    _check_cuda("s2pa_bank_bwd", bank, wt, ids, order, (bank, wt, qe, km, mask, g_ctx, g_w))
    d_qe = torch.empty_like(qe)
    if N:
        with torch.cuda.device(device):
            rc = cuda_build.library().s2pa_bank_bwd(
                bank.data_ptr(), ids.data_ptr(), order.data_ptr(), qe.data_ptr(), km.data_ptr(),
                mask.data_ptr(), g_ctx.data_ptr(), g_w.data_ptr(), d_qe.data_ptr(), N, L, E,
                int(bank.dtype == torch.bfloat16), torch.cuda.current_stream(device).cuda_stream,
            )
        cuda_build.check_launch("s2pa_bank_bwd", rc)
        count_launch(s2pa_bank_bwd)
    return d_qe


s2pa_bank_bwd.launches = s2pa_bank_bwd.captured = 0


class S2PABankAttend(torch.autograd.Function):
    """(ctx_e, w) = s2pa_bank_fwd(bank, wt, qe, km, mask) with K2 as its
    backward. Saves the five inputs and, on the card, the slot order the
    forward computed (``slot_order``), never a gathered [N, L, E] copy; only qe gets a
    gradient (the bank is constant, the mask is a fixed keep-scale, wt and
    km are integers).

    Under autocast (amp) both passes run with autocast off: the kernels and
    their plain versions take the dtypes they are given (the caller casts qe
    to the bank dtype), K2 sees the forward's dtypes, and g_ctx arrives in
    ctx_e's dtype."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, bank, wt, qe, km, mask):
        with torch.autocast(bank.device.type, enabled=False):
            ids, order = slot_order(wt) if bank.device.type == "cuda" else (None, None)
            ctx.save_for_backward(bank, wt, qe, km, mask, ids, order)
            return _fwd(bank, wt, qe, km, mask, None if ids is None else (ids, order))

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g_ctx, g_w):
        bank, wt, qe, km, mask, ids, order = ctx.saved_tensors
        with torch.autocast(bank.device.type, enabled=False):
            d_qe = _bwd(bank, wt, qe, km, mask, g_ctx.contiguous(), g_w.contiguous(),
                        None if ids is None else (ids, order))
        return None, None, d_qe, None, None


def s2pa_bank_attend(bank, wt, qe, km, mask):
    """Differentiable gather-fused S2PA over the bank (K1 forward, K2
    backward); arguments and results as ``s2pa_bank_fwd``."""
    return S2PABankAttend.apply(bank, wt, qe, km, mask)
