"""Duration predictor (log domain) and its frame rounding.

Port of ``dicttts_tpu/models/duration.py``: the PortaSpeech Softplus head
(``softplus_out``, the default here) or FastSpeech2's plain linear one.
Parameter names follow the reference's per-layer ``Sequential``
(``conv.{i}.1`` is the conv, ``conv.{i}.3`` the LayerNorm) and its
``linear.0`` head, which ``convert_duration_predictor`` reads.

Under amp it runs in f32 with autocast off (``ops/amp.f32_island``): the
JAX module has no compute dtype, so its layers promote to f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dicttts_tpu_torch.models.layers import conv1d_tc, dropout
from dicttts_tpu_torch.ops.amp import f32_island


class DurationPredictor(nn.Module):
    """n_layers of [conv-k SAME, relu, LayerNorm(1e-5), dropout], masked
    after each, then Linear (-> Softplus with ``softplus_out``), masked.
    Input [B, T, C] -> [B, T] log-duration."""

    def __init__(self, in_channels: int, n_chans: int = 128, n_layers: int = 3,
                 kernel_size: int = 5, dropout_rate: float = 0.0, softplus_out: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.softplus_out = softplus_out
        layers = []
        for i in range(n_layers):
            # the Sequential slots 0/2/4 (pad, relu, dropout) hold no
            # parameters; forward applies the conv and the LayerNorm itself
            layers.append(nn.Sequential(
                nn.Identity(),
                nn.Conv1d(in_channels if i == 0 else n_chans, n_chans, kernel_size,
                          padding=kernel_size // 2),
                nn.ReLU(),
                nn.LayerNorm(n_chans, eps=1e-5),
                nn.Identity(),
            ))
        self.conv = nn.ModuleList(layers)
        self.linear = nn.Sequential(nn.Linear(n_chans, 1))

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x, nonpadding = x.float(), nonpadding.float()
        with f32_island(x.device.type):
            for layer in self.conv:
                x = torch.relu(conv1d_tc(x, layer[1]))
                x = dropout(layer[3](x), self.dropout_rate, self.training, generator)
                x = x * nonpadding[:, :, None]
            x = self.linear(x)[..., 0]
            return (F.softplus(x) if self.softplus_out else x) * nonpadding


def out2dur(log_dur: torch.Tensor, offset: float = 1.0) -> torch.Tensor:
    """Log-domain prediction -> non-negative int32 frame counts (round half
    to even, as jnp.round)."""
    return torch.clamp(torch.round(torch.exp(log_dur) - offset), min=0.0).to(torch.int32)
