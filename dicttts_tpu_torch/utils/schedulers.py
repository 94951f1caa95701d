"""Learning-rate schedules as functions of the update count.

Port of ``dicttts_tpu/utils/schedulers.py``. As in optax, an optimizer's
first update reads the schedule at count 0, and a skipped update does not
advance the count.
"""

from __future__ import annotations

import math


def rsqrt_schedule(lr: float, warmup_updates: int, hidden_size: int, floor: float = 1e-7):
    """Noam: lr * min(count / warmup, 1) * max(warmup, count)^-0.5 *
    hidden^-0.5, floored at ``floor``."""
    rsqrt_hidden = hidden_size ** -0.5

    def schedule(count: int) -> float:
        warmup = min(count / warmup_updates, 1.0)
        return max(lr * warmup * max(float(warmup_updates), float(count)) ** -0.5 * rsqrt_hidden,
                   floor)

    return schedule


def step_decay_schedule(lr: float, step_size: int, gamma: float):
    """StepLR: lr * gamma^floor(count / step_size)."""

    def schedule(count: int) -> float:
        return lr * gamma ** math.floor(count / step_size)

    return schedule
