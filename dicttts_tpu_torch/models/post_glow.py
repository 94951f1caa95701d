"""Post-net Glow: the mel-refining normalizing flow of PortaSpeech's flow
recipe.

Port of ``dicttts_tpu/models/post_glow.py``. The mels are squeezed in time
(pairs of frames folded into channels), then n_blocks x [ActNorm,
InvConvNear, GlowCoupling] run on them, conditioned on the squeezed
conditioning g. Forward gives (z, log-det) for the training NLL; reverse
turns a noise sample back into mels. The whole flow runs in f32 with
autocast off (``ops/amp.f32_island``), as the JAX module is an f32 island
under amp.

- ``InvConvNear`` mixes each group of ``n_split`` channels with one
  invertible n_split x n_split matrix. The group takes n_split / 2
  channels from each coupling half, so that every channel passes through a
  coupling (the JAX package's interleave, kept exactly).
- ``share_wn_layers`` k > 0 shares one WN across each run of k blocks. The
  shared stacks belong to the Glow (``shared_wn.{s}``) and are handed to
  the couplings at call time, so ``state_dict`` lists each once; without
  sharing each coupling owns its ``enc``.

Parameter names: ``actnorm.{i}.logs/bias``, ``invconv.{i}.weight``,
``coupling.{i}.pre/enc/post``, ``shared_wn.{s}`` (``convert.glow_state``).
"""

from __future__ import annotations

import torch
from torch import nn

from dicttts_tpu_torch.models.layers import linear_1x1
from dicttts_tpu_torch.models.wavenet import WN
from dicttts_tpu_torch.ops.amp import f32_island


def squeeze(x: torch.Tensor, x_mask: torch.Tensor | None, n_sqz: int = 2):
    """[B, T, C] -> [B, T // n_sqz, C * n_sqz] and its mask [B, T // n_sqz, 1]:
    a squeezed step is valid only where all its frames are."""
    B, T, C = x.shape
    t = (T // n_sqz) * n_sqz
    x = x[:, :t].reshape(B, t // n_sqz, n_sqz * C)
    if x_mask is not None:
        x_mask = x_mask[:, n_sqz - 1::n_sqz, :1]
    else:
        x_mask = torch.ones((B, t // n_sqz, 1), dtype=x.dtype, device=x.device)
    return x * x_mask, x_mask


def unsqueeze(x: torch.Tensor, x_mask: torch.Tensor | None, n_sqz: int = 2):
    """Inverse of ``squeeze``: [B, T', C * n_sqz] -> [B, T' * n_sqz, C]."""
    B, Tq, Cq = x.shape
    x = x.reshape(B, Tq * n_sqz, Cq // n_sqz)
    if x_mask is not None:
        x_mask = torch.repeat_interleave(x_mask, n_sqz, dim=1)
    else:
        x_mask = torch.ones((B, Tq * n_sqz, 1), dtype=x.dtype, device=x.device)
    return x * x_mask, x_mask


class ActNorm(nn.Module):
    """Per-channel affine y = x * exp(logs) + bias, log-det sum(logs) * frames."""

    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, x_mask, reverse: bool = False):
        frames = x_mask.sum(dim=(1, 2))
        if not reverse:
            return (x * torch.exp(self.logs) + self.bias) * x_mask, self.logs.sum() * frames
        return (x - self.bias) * torch.exp(-self.logs) * x_mask, -self.logs.sum() * frames


def logabsdet_and_inverse(w: torch.Tensor, inverse: bool) -> tuple:
    """log|det w| of a small square ``w``, and its inverse if ``inverse``
    (else None): LU with partial pivoting in LAPACK's order (multipliers
    a[i, k] * (1 / a[k, k]) below the pivot, log|det| the sum of
    log|U_kk|: on the CPU the bits of ``torch.linalg.slogdet``), then
    back substitution, written in plain tensor ops. ``torch.linalg.slogdet``
    and ``inv`` go to cuSOLVER or MAGMA on the card, which check their
    ``info`` on the host, and a CUDA graph cannot capture that; these ops
    capture, and autograd differentiates them."""
    S = w.shape[0]
    rows = torch.arange(S, device=w.device)
    a = w
    b = torch.eye(S, dtype=w.dtype, device=w.device) if inverse else None  # P, then L^-1 P
    pivots = []
    for k in range(S):
        piv = torch.argmax(torch.where(rows >= k, a[:, k].abs(), -1.0))
        perm = torch.where(rows == k, piv, torch.where(rows == piv, k, rows))
        a = a[perm]
        pivots.append(a[k, k])
        below = (rows > k)[:, None]
        mult = a[:, k:k + 1] * (1.0 / a[k, k])
        a = torch.where(below, a - mult * a[k:k + 1], a)
        if inverse:
            b = b[perm]
            b = torch.where(below, b - mult * b[k:k + 1], b)
    logabs = torch.log(torch.stack(pivots).abs()).sum()
    if not inverse:
        return logabs, None
    out = [None] * S
    for k in reversed(range(S)):
        row = b[k]
        for j in range(k + 1, S):
            row = row - a[k, j] * out[j]
        out[k] = row / a[k, k]
    return logabs, torch.stack(out)


class InvConvNear(nn.Module):
    """Invertible 1x1 convolution over channel groups of ``n_split``. Its
    log-determinant and inverse come from ``logabsdet_and_inverse``."""

    def __init__(self, channels: int, n_split: int = 4):
        super().__init__()
        self.n_split = n_split
        self.weight = nn.Parameter(torch.linalg.qr(torch.randn(n_split, n_split))[0])

    def forward(self, x, x_mask, reverse: bool = False):
        B, T, C = x.shape
        S = self.n_split
        frames = x_mask.sum(dim=(1, 2))
        logabsdet, inv = logabsdet_and_inverse(self.weight, reverse)
        if not reverse:
            mat, logdet = self.weight, (C // S) * logabsdet * frames
        else:
            mat, logdet = inv, -(C // S) * logabsdet * frames
        # group g of S channels: S/2 from the first coupling half, S/2 from the second
        y = x.reshape(B, T, 2, C // S, S // 2).transpose(2, 3).reshape(B, T, C // S, S)
        y = torch.matmul(y, mat.t())
        y = y.reshape(B, T, C // S, 2, S // 2).transpose(2, 3).reshape(B, T, C)
        return y * x_mask, logdet


class GlowCoupling(nn.Module):
    """Affine coupling: the first channel half, through pre -> WN -> post,
    gives the mean and log-scale of the second. ``post`` is zero at
    initialisation. With ``own_wn`` False the WN comes with each call."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, n_layers: int,
                 gin_channels: int = 0, sigmoid_scale: bool = False, own_wn: bool = True):
        super().__init__()
        self.half = channels // 2
        self.sigmoid_scale = sigmoid_scale
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels) if own_wn else None
        self.post = nn.Conv1d(hidden_channels, 2 * self.half, 1)
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def forward(self, x, x_mask, g=None, reverse: bool = False, wn: WN | None = None):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = linear_1x1(x0, self.pre) * x_mask
        h = (self.enc if wn is None else wn)(h, x_mask, g)
        stats = linear_1x1(h, self.post) * x_mask
        m, logs = stats[..., :self.half], stats[..., self.half:]
        if self.sigmoid_scale:
            logs = torch.log(1e-6 + torch.sigmoid(logs + 2.0))
        if not reverse:
            y1 = (m + x1 * torch.exp(logs)) * x_mask
            logdet = (logs * x_mask).sum(dim=(1, 2))
        else:
            y1 = (x1 - m) * torch.exp(-logs) * x_mask
            logdet = -(logs * x_mask).sum(dim=(1, 2))
        return torch.cat([x0, y1], dim=-1), logdet


class Glow(nn.Module):
    """n_blocks x [ActNorm, InvConvNear, GlowCoupling] on time-squeezed mels.

    forward(x, x_mask, g) -> (z, log-det [B]); forward(z, x_mask, g,
    reverse=True) -> (x, -log-det). x: [B, T, in_channels] with T a multiple
    of n_sqz; x_mask: [B, T, 1] or None; g: [B, T, gin_channels] or None."""

    def __init__(self, in_channels: int = 80, hidden_channels: int = 192, kernel_size: int = 3,
                 n_blocks: int = 12, n_block_layers: int = 3, n_split: int = 4, n_sqz: int = 2,
                 gin_channels: int = 0, share_wn_layers: int = 0, sigmoid_scale: bool = False):
        super().__init__()
        C, G = in_channels * n_sqz, gin_channels * n_sqz
        self.n_sqz = n_sqz
        self.share_wn_layers = share_wn_layers
        shared = share_wn_layers > 0
        self.shared_wn = nn.ModuleList(
            WN(hidden_channels, kernel_size, 1, n_block_layers, G)
            for _ in range(-(-n_blocks // share_wn_layers) if shared else 0))
        self.actnorm = nn.ModuleList(ActNorm(C) for _ in range(n_blocks))
        self.invconv = nn.ModuleList(InvConvNear(C, n_split) for _ in range(n_blocks))
        self.coupling = nn.ModuleList(
            GlowCoupling(C, hidden_channels, kernel_size, n_block_layers, G, sigmoid_scale,
                         own_wn=not shared) for _ in range(n_blocks))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                g: torch.Tensor | None = None, reverse: bool = False):
        if x.shape[1] % self.n_sqz != 0:
            raise ValueError(f"Glow input length {x.shape[1]} is not a multiple of n_sqz="
                             f"{self.n_sqz}; pad max_frames / frames_multiple to it")
        x_mask = None if x_mask is None else x_mask.float()
        with f32_island(x.device.type):
            x, mask = squeeze(x.float(), x_mask, self.n_sqz)
            if g is not None:
                g, _ = squeeze(g.float(), x_mask, self.n_sqz)
            total = torch.zeros(x.shape[0], device=x.device)
            order = range(len(self.coupling))
            for i in (reversed(order) if reverse else order):
                wn = self.shared_wn[i // self.share_wn_layers] if len(self.shared_wn) else None
                if not reverse:
                    x, ld_a = self.actnorm[i](x, mask)
                    x, ld_i = self.invconv[i](x, mask)
                    x, ld_c = self.coupling[i](x, mask, g, wn=wn)
                else:
                    x, ld_c = self.coupling[i](x, mask, g, reverse=True, wn=wn)
                    x, ld_i = self.invconv[i](x, mask, reverse=True)
                    x, ld_a = self.actnorm[i](x, mask, reverse=True)
                total = total + ld_a + ld_i + ld_c
            x, _ = unsqueeze(x, mask, self.n_sqz)
        return x, total
