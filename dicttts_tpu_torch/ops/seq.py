"""Sequence glue: masks, length regulation, the word-to-frame gather, and
the word pooling, word masks and intra-word positions of PortaSpeech.

Port of ``dicttts_tpu/ops/seq.py``. All functions take and return
feature-last ``[B, T, C]`` tensors and integer maps, as the JAX versions do.
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask (True inside the sequence)."""
    return torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)[None, :] < lengths[:, None]


def length_regulate(
    durations: torch.Tensor, max_frames: int, nonpadding: torch.Tensor | None = None
) -> torch.Tensor:
    """Expand per-token durations [B, T] into a mel2token map [B, max_frames].

    Frame f maps to token ``t+1`` iff ``cumsum[t-1] <= f < cumsum[t]``;
    frames past the total are 0. When ``nonpadding`` is given, a row whose
    durations are all zero falls back to duration 1 on its real tokens.
    """
    if nonpadding is not None:
        all_zero = durations.sum(dim=-1, keepdim=True) == 0
        durations = torch.where(all_zero, nonpadding.to(durations.dtype), durations)
    csum = torch.cumsum(durations, dim=-1).contiguous()  # [B, T], non-decreasing
    B = csum.shape[0]
    frames = torch.arange(max_frames, device=csum.device, dtype=csum.dtype)
    # token index of each frame = number of cumsum entries <= frame
    mel2token = torch.searchsorted(csum, frames.expand(B, max_frames).contiguous(), right=True) + 1
    total = csum[:, -1:]
    return torch.where(frames[None, :] < total, mel2token, 0).to(torch.int32)


def gather_expand(x: torch.Tensor, mel2token: torch.Tensor) -> torch.Tensor:
    """x [B, T, C], mel2token [B, F] (1-based, 0 = pad) -> [B, F, C];
    pad frames read a zero row."""
    x = torch.nn.functional.pad(x, (0, 0, 1, 0))
    idx = mel2token.long()[:, :, None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def pad_frames_multiple(mel2token: torch.Tensor, frames_multiple: int) -> torch.Tensor:
    """Extend each row's last real token id so its length becomes a multiple
    of ``frames_multiple`` (capped at the static width)."""
    if frames_multiple <= 1:
        return mel2token
    F = mel2token.shape[1]
    lengths = (mel2token > 0).to(torch.int32).sum(dim=-1)  # [B]
    padded_len = torch.clamp((lengths + frames_multiple - 1) // frames_multiple * frames_multiple, max=F)
    frames = torch.arange(F, device=mel2token.device, dtype=torch.int32)[None, :]
    last = torch.gather(mel2token, 1, torch.clamp(lengths - 1, min=0).long()[:, None])  # [B, 1]
    extend = (frames >= lengths[:, None]) & (frames < padded_len[:, None])
    return torch.where(extend, last, mel2token)


def mel2token_to_dur(mel2token: torch.Tensor, max_tokens: int) -> torch.Tensor:
    """Invert a mel2token map [B, F] (1-based, 0 = pad) into per-token
    durations [B, max_tokens] int32."""
    ids = torch.arange(1, max_tokens + 1, device=mel2token.device, dtype=mel2token.dtype)
    return (mel2token[:, :, None] == ids).sum(dim=1).to(torch.int32)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over positions where mask is nonzero (mask broadcasts to x)."""
    mask = mask.to(x.dtype).expand_as(x)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _segment_onehot(seg_ids: torch.Tensor, max_len: int, dtype: torch.dtype) -> torch.Tensor:
    """[B, T] 1-based segment ids (0 = pad) -> [B, T, max_len] one-hot."""
    ids = torch.arange(1, max_len + 1, device=seg_ids.device, dtype=seg_ids.dtype)
    return (seg_ids[:, :, None] == ids).to(dtype)


def group_hidden_by_segs(h: torch.Tensor, seg_ids: torch.Tensor, max_len: int) -> torch.Tensor:
    """Mean-pool h [B, T, C] into [B, max_len, C] segments by 1-based
    ``seg_ids`` [B, T] (0 = pad, dropped); an empty segment is zero."""
    onehot = _segment_onehot(seg_ids, max_len, h.dtype)
    summed = torch.einsum("btc,bts->bsc", h, onehot)
    counts = onehot.sum(dim=1)[:, :, None]
    return summed / torch.clamp(counts, min=1.0)


def scatter_sum_by_segs(values: torch.Tensor, seg_ids: torch.Tensor, max_len: int) -> torch.Tensor:
    """Sum values [B, T] into [B, max_len] segments (1-based ids, 0 dropped)."""
    return torch.einsum("bt,bts->bs", values, _segment_onehot(seg_ids, max_len, values.dtype))


def build_word_mask(x2word: torch.Tensor, y2word: torch.Tensor) -> torch.Tensor:
    """[B, Tx], [B, Ty] -> [B, Tx, Ty] int32, 1 where the word ids are equal
    (pad id 0 equals pad id 0)."""
    return (x2word[:, :, None] == y2word[:, None, :]).to(torch.int32)


def intra_word_positions(word2word: torch.Tensor, x2word: torch.Tensor) -> torch.Tensor:
    """Position of each element of x2word [B, T] within its word, in
    (0, 1]: the k-th of a word of n elements gets k / n; elements of no
    word in ``word2word`` [B, W] (arange + 1) get 0."""
    mask = build_word_mask(word2word, x2word).float()  # [B, W, T]
    cums = torch.cumsum(mask, dim=-1)
    denom = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
    return (cums / denom * mask).sum(dim=1)
