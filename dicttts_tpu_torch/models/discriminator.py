"""Multi-window mel discriminator for adversarial acoustic-model training.

Port of ``dicttts_tpu/models/discriminator.py`` (``instance_norm_2d``,
``Disc2DBlockStack``, ``MultiWindowDiscriminator``) with the recipe's
instance norm and ``reduction='stack'``; batch norm, the ``sum``
reduction and the JCU discriminator are not ported. For each window
length (32/64/128 frames) a crop of the mel is scored by a 3-block
stride-2 CNN, giving ``[B, n_windows]`` validities. Crop starts are drawn
from a ``torch.Generator`` or passed in as ``start_frames``, and are
computed on the device, so drawing them makes no host round trip. Windows longer than
the batch's longest sequence are masked by the returned ``win_valid``, as
in the JAX module.

Convolutions run NCHW; the last feature map is flattened in the JAX
module's NHWC order, so the head's weight is the flax kernel transposed.
Parameter names mirror the flax tree (``win_32.conv_0``, ``win_32.in_gamma_1``,
``win_32.adv``); ``convert.discriminator_state`` maps one onto the other.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dicttts_tpu_torch.models.layers import dropout


def instance_norm_2d(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Normalize [B, C, H, W] per (H, W) per channel, statistics in f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps) * gamma[:, None, None] + beta[:, None, None]
    return out.to(x.dtype)


class Disc2DBlockStack(nn.Module):
    """3 x [conv3x3 stride 2, LeakyReLU(0.2), dropout, instance norm on the
    non-first blocks], then a linear head over the flattened map.
    Input [B, T_win, M] -> validity [B, 1] and the three feature maps
    (NHWC, as the JAX module returns them)."""

    def __init__(self, time_length: int, freq_length: int = 80, hidden_size: int = 128,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.dropout_rate = dropout_rate
        for i in range(3):
            self.add_module(f"conv_{i}", nn.Conv2d(1 if i == 0 else hidden_size, hidden_size, 3,
                                                   stride=2, padding=1))
            if i > 0:
                self.register_parameter(f"in_gamma_{i}", nn.Parameter(torch.ones(hidden_size)))
                self.register_parameter(f"in_beta_{i}", nn.Parameter(torch.zeros(hidden_size)))
        t, m = time_length, freq_length
        for _ in range(3):
            t, m = (t + 1) // 2, (m + 1) // 2
        self.adv = nn.Linear(t * m * hidden_size, 1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        h = x[:, None]  # [B, 1, T_win, M]
        feats = []
        for i in range(3):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), 0.2)
            h = dropout(h, self.dropout_rate, self.training, generator)
            if i > 0:
                h = instance_norm_2d(h, getattr(self, f"in_gamma_{i}"), getattr(self, f"in_beta_{i}"))
            feats.append(h.permute(0, 2, 3, 1))
        return self.adv(feats[-1].reshape(h.shape[0], -1)), feats


class MultiWindowDiscriminator(nn.Module):
    def __init__(self, time_lengths: Sequence[int] = (32, 64, 128), freq_length: int = 80,
                 hidden_size: int = 128, dropout_rate: float = 0.25):
        super().__init__()
        self.time_lengths = tuple(time_lengths)
        self.discs = nn.ModuleDict({
            f"win_{w}": Disc2DBlockStack(w, freq_length, hidden_size, dropout_rate)
            for w in self.time_lengths})

    def forward(self, mels: torch.Tensor, lengths: torch.Tensor,
                start_frames: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict:
        """mels [B, T, M], lengths [B] frame counts; start_frames
        [n_windows] int crop starts, or None to draw them from ``generator``
        (start = floor(u * (max(lengths) - win + 1)), u uniform). Returns
        y [B, n_windows], h (feature maps),
        start_frames [n_windows] and win_valid [n_windows] (1.0 where the
        window fits the longest sequence)."""
        T = mels.shape[1]
        max_len = lengths.max()
        if start_frames is None:
            if generator is None:
                raise ValueError("drawing crop starts needs a torch.Generator")
            u = torch.rand(len(self.time_lengths), generator=generator, device=mels.device)
        validities, feats, starts, valid = [], [], [], []
        for i, win in enumerate(self.time_lengths):
            if start_frames is None:
                t_end = torch.clamp(max_len - win, min=0)
                start = torch.floor(u[i] * (t_end + 1).float()).long()
            else:
                start = torch.as_tensor(start_frames[i], device=mels.device).long()
            start = torch.clamp(start, 0, max(T - win, 0))
            # batches shorter than the window: pad (win_valid masks the loss)
            src = mels if T >= win else F.pad(mels, (0, 0, 0, win - T))
            idx = start + torch.arange(win, device=mels.device)
            v, f = self.discs[f"win_{win}"](torch.index_select(src, 1, idx), generator)
            validities.append(v)
            feats.extend(f)
            starts.append(start)
            valid.append((max_len >= win).float())
        return {"y": torch.cat(validities, dim=-1), "h": feats, "start_frames": torch.stack(starts),
                "win_valid": torch.stack(valid)}
