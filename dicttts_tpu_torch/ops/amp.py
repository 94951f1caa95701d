"""Mixed precision (amp) for the training and inference passes.

Port of ``dicttts_tpu/ops/amp.py``. The JAX package threads an activation
dtype through its modules and sets a bf16 matmul precision; this port uses
PyTorch's idiom instead: the task runs its model and discriminator passes
under ``torch.autocast(device_type, dtype=torch.bfloat16)``. Parameters and
optimizer state stay f32. The JAX package's f32 islands stay f32 here,
each inside ``f32_island`` with its inputs cast to f32: the prior flow, the
KL, the S2PA softmax statistics and sense remap, and every loss.

``amp_bf16_activations`` keeps its meaning: it defaults to ``amp``. With
``amp`` on and ``amp_bf16_activations`` off, the JAX package keeps f32
activations and lowers only the matmul precision to bf16; here that is
``torch.set_float32_matmul_precision("medium")`` for the scope (f32
matmuls on the card may use bf16 products; the CPU ignores it, as XLA's
CPU backend ignores the JAX setting).
"""

from __future__ import annotations

import contextlib

import torch


def task_activation_dtype(cfg: dict) -> torch.dtype | None:
    """bf16 when ``amp_bf16_activations`` (default: the ``amp`` flag), else None."""
    if cfg.get("amp_bf16_activations", bool(cfg.get("amp"))):
        return torch.bfloat16
    return None


@contextlib.contextmanager
def _matmul_precision(precision: str):
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def amp_scope(device: torch.device, act_dtype: torch.dtype | None, amp: bool = False):
    """The scope of a task's model and discriminator passes: autocast to
    ``act_dtype`` when it is set; else, under ``amp``, bf16 matmul
    precision for f32 matmuls; else nothing."""
    if act_dtype is not None:
        return torch.autocast(device.type, dtype=act_dtype)
    if amp:
        return _matmul_precision("medium")
    return contextlib.nullcontext()


def f32_island(device_type: str):
    """Autocast off inside: what runs here computes in its inputs' dtype
    (the callers cast them to f32)."""
    return torch.autocast(device_type, enabled=False)
