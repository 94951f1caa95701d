"""Learning-rate schedules as functions of the update count.

Port of ``dicttts_tpu/utils/schedulers.py``. As in optax, an optimizer's
first update reads the schedule at count 0, and a skipped update does not
advance the count.

A schedule takes the count as a Python number (the value a float) or as a
tensor on any device (the value a float64 tensor of the count's shape), so
an optimizer whose count lives on the card reads its lr there without a
host sync. The rsqrt schedule's two forms give the same double bit for bit
on the CPU, where torch's float64 rsqrt rounds as 1 / math.sqrt does (and
its sqrt does not); on the card the rsqrt is within an ulp. The step decay
raises gamma to an integer power: exact in both forms for a gamma that is
a power of two (the recipes' 0.5), within an ulp of a double otherwise.
"""

from __future__ import annotations

import math

import torch


def rsqrt_schedule(lr: float, warmup_updates: int, hidden_size: int, floor: float = 1e-7):
    """Noam: lr * min(count / warmup, 1) * max(warmup, count)^-0.5 *
    hidden^-0.5, floored at ``floor``."""
    rsqrt_hidden = 1.0 / math.sqrt(hidden_size)
    warmup_f = float(warmup_updates)

    def schedule(count):
        if isinstance(count, torch.Tensor):
            c = count.to(torch.float64)
            warmup = torch.clamp(c / warmup_f, max=1.0)
            value = lr * warmup * torch.rsqrt(torch.clamp(c, min=warmup_f)) * rsqrt_hidden
            return torch.clamp(value, min=floor)
        warmup = min(count / warmup_f, 1.0)
        return max(lr * warmup * (1.0 / math.sqrt(max(warmup_f, float(count)))) * rsqrt_hidden, floor)

    return schedule


def step_decay_schedule(lr: float, step_size: int, gamma: float):
    """StepLR: lr * gamma^floor(count / step_size)."""

    def schedule(count):
        if isinstance(count, torch.Tensor):
            return lr * torch.pow(gamma, torch.floor(count.to(torch.float64) / step_size))
        return lr * gamma ** math.floor(count / step_size)

    return schedule
