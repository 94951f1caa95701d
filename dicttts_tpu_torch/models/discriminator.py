"""Multi-window mel discriminator for adversarial acoustic-model training.

Port of ``dicttts_tpu/models/discriminator.py``: ``instance_norm_2d``,
``Disc2DBlockStack``, ``MultiWindowDiscriminator`` and
``JCUDiscriminator``. For each window length (32/64/128 frames) a crop of
the mel is scored by a 3-block stride-2 CNN, giving ``[B, n_windows]``
validities (``reduction='stack'``, the recipe's) or their sum over the
windows, ``[B, 1]`` (``'sum'``). ``norm_type='in'`` (the recipe's) puts an
instance norm on the non-first blocks; any other value means no norm at
all, as in the JAX module (which has no batch norm). Crop starts are drawn
from a ``torch.Generator`` or passed in as ``start_frames``, and are
computed on the device, so drawing them makes no host round trip. Windows longer than
the batch's longest sequence are masked by the returned ``win_valid``, as
in the JAX module; under data parallelism the longest sequence is the
global batch's (``parallel/mesh.global_max``), while each rank draws its
own crop starts.

Under amp the convolutions run in bf16 and the head of each window, and
all of ``JCUDiscriminator``, in f32 with autocast off
(``ops/amp.f32_island``), as the JAX modules give only the window convs a
compute dtype.

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
from dicttts_tpu_torch.ops.amp import f32_island
from dicttts_tpu_torch.parallel.mesh import global_max


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
    non-first blocks when ``norm_type == 'in'``], then a linear head over the
    flattened map. Input [B, T_win, M] -> validity [B, 1] and the three
    feature maps (NHWC, as the JAX module returns them)."""

    def __init__(self, time_length: int, freq_length: int = 80, hidden_size: int = 128,
                 dropout_rate: float = 0.25, norm_type: str = "in"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm = norm_type == "in"
        for i in range(3):
            self.add_module(f"conv_{i}", nn.Conv2d(1 if i == 0 else hidden_size, hidden_size, 3,
                                                   stride=2, padding=1))
            if i > 0 and self.norm:
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
            if i > 0 and self.norm:
                h = instance_norm_2d(h, getattr(self, f"in_gamma_{i}"), getattr(self, f"in_beta_{i}"))
            feats.append(h.permute(0, 2, 3, 1))
        with f32_island(h.device.type):
            return self.adv(feats[-1].reshape(h.shape[0], -1).float()), feats


class MultiWindowDiscriminator(nn.Module):
    def __init__(self, time_lengths: Sequence[int] = (32, 64, 128), freq_length: int = 80,
                 hidden_size: int = 128, dropout_rate: float = 0.25, norm_type: str = "in",
                 reduction: str = "stack"):
        super().__init__()
        self.time_lengths = tuple(time_lengths)
        self.reduction = reduction
        self.discs = nn.ModuleDict({
            f"win_{w}": Disc2DBlockStack(w, freq_length, hidden_size, dropout_rate, norm_type)
            for w in self.time_lengths})

    def forward(self, mels: torch.Tensor, lengths: torch.Tensor,
                start_frames: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict:
        """mels [B, T, M], lengths [B] frame counts; start_frames
        [n_windows] int crop starts, or None to draw them from ``generator``
        (start = floor(u * (max(lengths) - win + 1)), u uniform). Returns
        y [B, n_windows] (``'sum'``: [B, 1]), h (feature maps),
        start_frames [n_windows] and win_valid [n_windows] (1.0 where the
        window fits the longest sequence)."""
        T = mels.shape[1]
        max_len = global_max(lengths.max())  # the global batch's, under data parallelism
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
        y = torch.cat(validities, dim=-1)
        if self.reduction == "sum":
            y = y.sum(dim=-1, keepdim=True)
        return {"y": y, "h": feats, "start_frames": torch.stack(starts), "win_valid": torch.stack(valid)}


class JCUDiscriminator(nn.Module):
    """Joint conditional / unconditional discriminator: a mel branch
    (reflect-padded stride-2 conv, then two k5 convs), a condition branch
    (reflect-padded stride-2 conv), a conditional head on both branches'
    features and an unconditional head on the mel's. Feature-last [B, T, C]
    in and out; returns {'y_c': unconditional, 'y': conditional}, each
    [B, T / 2, 1], the JAX module's key names. Layer names are the flax
    module's, so ``convert.jcu_state`` maps one onto the other."""

    def __init__(self, in_channels: int = 80, cond_channels: int = 192, c_base: int = 128):
        super().__init__()

        def conv(name, c_in, c_out, k, stride=1, padding=0):
            self.add_module(name, nn.Conv1d(c_in, c_out, k, stride=stride, padding=padding))

        conv("cond_conv", cond_channels, c_base, 5, stride=2)
        conv("x_conv_0", in_channels, c_base, 5, stride=2)
        conv("x_conv_1", c_base, c_base, 5, padding=2)
        conv("x_conv_2", c_base, c_base, 5, padding=2)
        conv("cond_head_0", 2 * c_base, c_base, 5, padding=2)
        conv("cond_head_1", c_base, 1, 3, padding=1)
        conv("x_head_0", c_base, c_base, 5, padding=2)
        conv("x_head_1", c_base, 1, 3, padding=1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> dict:
        def refl_stride2(h, conv):
            return conv(F.pad(h, (2, 2), mode="reflect"))

        def act(h):
            return F.leaky_relu(h, 0.2)

        with f32_island(x.device.type):
            c = act(refl_stride2(cond.float().transpose(1, 2), self.cond_conv))
            h = act(refl_stride2(x.float().transpose(1, 2), self.x_conv_0))
            h = act(self.x_conv_1(h))
            h = act(self.x_conv_2(h))
            yc = self.cond_head_1(act(self.cond_head_0(torch.cat([c, h], dim=1))))
            yu = self.x_head_1(act(self.x_head_0(h)))
        return {"y_c": yu.transpose(1, 2), "y": yc.transpose(1, 2)}
