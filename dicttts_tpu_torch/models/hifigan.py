"""HiFi-GAN: the generator, mel [B, T, 80] -> waveform [B, T * prod(rates)],
and the multi-period and multi-scale discriminators that train it.

Port of the math of ``dicttts_tpu/models/hifigan.py`` (``HifiGanGenerator``,
``ResBlock1``/``ResBlock2``, the upsampling convs): conv_pre(k7) -> per
stage [leaky_relu(0.1), transposed-conv upsample with (k - u) // 2 padding,
mean of the multi-receptive-field ResBlocks] -> leaky_relu(0.01) ->
conv_post(k7) -> tanh. The TPU version's lane folding and subpixel
rewrite are layouts for the TPU's vector lanes and are not ported: the
convolutions here are plain ``conv1d`` / ``conv_transpose1d``, as XLA ran
them outside any Pallas kernel. Parameter names follow the reference
generator (``conv_pre``, ``ups.{i}``, ``resblocks.{r}.convs1.{d}``,
``conv_post``), which ``convert_hifigan_generator`` reads.

The discriminators follow the JAX modules (``DiscriminatorP``,
``DiscriminatorS``, ``MultiPeriodDiscriminator``,
``MultiScaleDiscriminator``; no weight or spectral norm), their padding
included, which is not upstream torch's:

- a period discriminator reflect-pads T up to a multiple of its period,
  folds the wave into [T / p, p] and runs 2-D convs (5, 1) with stride
  (3, 1) and padding (2, 2) on time, then a (5, 1) conv and a (3, 1) head;
- a scale discriminator runs grouped 1-D convs (groups 1, 4, 16, 16, 16,
  16, 1) with flax's "SAME" padding, which for a strided conv is
  asymmetric: (ceil(T / s) - 1) * s + k - T in all, the low side half of it
  rounded down (18 | 19 for k = 41, s = 4 at T = 8192, where torch's
  symmetric padding would give 20 | 20), so the pad is explicit;
- the multi-scale one downsamples between its scales by padding 2 zeros
  each side and averaging windows of 4 with stride 2.

Scores come back [B, N] in the JAX modules' order; feature maps are NCHW
(NCW), where the JAX modules' are channels-last (the losses take means).
Layer names are the flax modules' (``disc_p2.conv_0``, ``disc_s0.conv_post``),
so ``convert.hifigan_disc_state`` maps one tree onto the other.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


class ResBlock1(nn.Module):
    """3x [leaky, dilated conv, leaky, conv d=1] with residual adds."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        k = kernel_size
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, dilation=d, padding=d * (k - 1) // 2) for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, padding=(k - 1) // 2) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        for c1, c2 in zip(self.convs1, self.convs2):
            h = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = x + c2(F.leaky_relu(h, LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """Lighter variant: [leaky, dilated conv] with residual adds."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 3)):
        super().__init__()
        k = kernel_size
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, k, dilation=d, padding=d * (k - 1) // 2) for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HifiGanGenerator(nn.Module):
    def __init__(self, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 resblock: str = "1", in_channels: int = 80, c_out: int = 1):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        block = ResBlock1 if resblock == "1" else ResBlock2
        ch = upsample_initial_channel
        self.conv_pre = nn.Conv1d(in_channels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch_in, ch = ch, upsample_initial_channel // 2 ** (i + 1)
            self.ups.append(nn.ConvTranspose1d(ch_in, ch, k, u, padding=(k - u) // 2))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(block(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, c_out, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, C_mel] -> wav [B, T * prod(upsample_rates)]."""
        x = self.conv_pre(mel.transpose(1, 2))
        nk = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            acc = self.resblocks[i * nk](x)
            for j in range(1, nk):
                acc = acc + self.resblocks[i * nk + j](x)
            x = acc / nk
        x = self.conv_post(F.leaky_relu(x))  # default slope 0.01
        return torch.tanh(x)[:, 0]


class DiscriminatorP(nn.Module):
    """Period discriminator: [B, T] -> score [B, N], 6 feature maps."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        k = kernel_size
        for i, (c_in, c_out) in enumerate(zip((1, 32, 128, 512), (32, 128, 512, 1024))):
            self.add_module(f"conv_{i}", nn.Conv2d(c_in, c_out, (k, 1), (stride, 1), padding=(2, 0)))
        self.conv_4 = nn.Conv2d(1024, 1024, (k, 1), padding=(2, 0))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, wav: torch.Tensor):
        B, T = wav.shape
        pad = (-T) % self.period
        x = wav[:, None]
        if pad:
            x = F.pad(x, (0, pad), mode="reflect" if T > 1 else "constant")
        x = x.reshape(B, 1, (T + pad) // self.period, self.period)
        fmap = []
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(B, -1), fmap


def same_pad(length: int, kernel_size: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding of a strided conv: (low, high)."""
    total = max((math.ceil(length / stride) - 1) * stride + kernel_size - length, 0)
    return total // 2, total - total // 2


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped strided 1-D convs on the raw wave,
    [B, T] -> score [B, N], 8 feature maps."""

    SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
             (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))  # (channels, k, stride, groups)

    def __init__(self):
        super().__init__()
        c_in = 1
        for i, (c, k, s, g) in enumerate(self.SPECS):
            self.add_module(f"conv_{i}", nn.Conv1d(c_in, c, k, s, groups=g))
            c_in = c
        self.conv_post = nn.Conv1d(c_in, 1, 3, padding=1)

    def forward(self, wav: torch.Tensor):
        x = wav[:, None]
        fmap = []
        for i, (_, k, s, _) in enumerate(self.SPECS):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(F.pad(x, same_pad(x.shape[-1], k, s))),
                             LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discs = nn.ModuleDict({f"disc_p{p}": DiscriminatorP(p) for p in periods})

    def forward(self, wav: torch.Tensor):
        outs = [d(wav) for d in self.discs.values()]
        return [s for s, _ in outs], [f for _, f in outs]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3):
        super().__init__()
        self.discs = nn.ModuleDict({f"disc_s{i}": DiscriminatorS() for i in range(n_scales)})

    def forward(self, wav: torch.Tensor):
        scores, fmaps = [], []
        x = wav
        for i, d in enumerate(self.discs.values()):
            if i > 0:  # mean of windows of 4, stride 2, over 2 zeros each side
                x = F.avg_pool1d(F.pad(x, (2, 2))[:, None], 4, 2)[:, 0]
            s, f = d(x)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


class HifiGanDiscriminator(nn.Module):
    """The MPD and the MSD together: wav [B, T] -> (scores, feature maps),
    the MPD's five then the MSD's three, as the JAX task concatenates them."""

    def __init__(self):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator()
        self.msd = MultiScaleDiscriminator()

    def forward(self, wav: torch.Tensor):
        s_p, f_p = self.mpd(wav)
        s_s, f_s = self.msd(wav)
        return s_p + s_s, f_p + f_s


def generator_adv_loss(fake_scores) -> torch.Tensor:
    """LSGAN: the sum over sub-discriminators of mean((D(fake) - 1)^2)."""
    return sum(torch.mean(torch.square(s - 1.0)) for s in fake_scores)


def discriminator_adv_loss(real_scores, fake_scores) -> torch.Tensor:
    """LSGAN: the sum of mean((D(real) - 1)^2) + mean(D(fake)^2)."""
    total = 0.0
    for r, f in zip(real_scores, fake_scores):
        total = total + torch.mean(torch.square(r - 1.0)) + torch.mean(torch.square(f))
    return total
