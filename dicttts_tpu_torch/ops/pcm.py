"""PCM output encodings for the serving path.

Port of ``dicttts_tpu/ops/pcm.py``: G.711-style mu-law companding, one
byte per sample where int16 PCM takes two. Elementwise torch ops, so the
encode runs on the vocoder's output where it lies.
"""

from __future__ import annotations

import math

import torch


def mulaw_encode(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """float waveform in [-1, 1] -> uint8 mu-law code (ITU-T G.711 shape)."""
    x = torch.clamp(x.float(), -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return ((y + 1.0) * 127.5 + 0.5).to(torch.uint8)


def mulaw_decode(u: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """uint8 mu-law code -> float waveform in [-1, 1]."""
    y = u.float() / 127.5 - 1.0
    return torch.sign(y) * (torch.pow(1.0 + mu, torch.abs(y)) - 1.0) / mu
