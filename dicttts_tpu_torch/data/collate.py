"""Host-side batching: padding collates and token-budget batch bucketing.

Port of ``dicttts_tpu/data/collate.py`` (numpy only): the padding collates,
fairseq-style ``batch_by_size``, ``shape_bucket``, which quantizes pad
lengths to a small set of shapes, and the length-sorted shuffled order.
The port keeps the JAX package's buckets so that its batches are the same
arrays.
"""

from __future__ import annotations

import sys

import numpy as np


def collate_1d(
    values,
    pad_value=0,
    max_len: int | None = None,
    shift_right: bool = False,
    shift_id=1,
    dtype=None,
) -> np.ndarray:
    """Stack a list of 1-D arrays into a right-padded [B, T] array."""
    values = [np.asarray(v) for v in values]
    size = max(len(v) for v in values) if max_len is None else max_len
    dtype = dtype or values[0].dtype
    out = np.full((len(values), size), pad_value, dtype=dtype)
    for i, v in enumerate(values):
        if shift_right:
            out[i, 1 : len(v)] = v[: len(v) - 1]
            out[i, 0] = shift_id
        else:
            out[i, : len(v)] = v
    return out


def collate_2d(values, pad_value=0, max_len: int | None = None, dtype=None) -> np.ndarray:
    """Stack a list of [T_i, C] arrays into a right-padded [B, T, C] array."""
    values = [np.asarray(v) for v in values]
    size = max(v.shape[0] for v in values) if max_len is None else max_len
    dtype = dtype or values[0].dtype
    out = np.full((len(values), size, values[0].shape[1]), pad_value, dtype=dtype)
    for i, v in enumerate(values):
        out[i, : v.shape[0]] = v
    return out


def collate_nd(values, pad_value=0, max_lens=None, dtype=None) -> np.ndarray:
    """Stack arbitrary-rank arrays, padding every leading axis independently.

    ``max_lens``: optional per-axis pad targets for all axes except the last
    (feature) axis when the arrays are float-like, or all axes for int maps.
    Used for the 4-D dict-bank structures (keys [T_w, L_k, 768] etc.).
    """
    values = [np.asarray(v) for v in values]
    shapes = np.array([v.shape for v in values])
    tgt = shapes.max(axis=0)
    if max_lens is not None:
        for ax, m in enumerate(max_lens):
            if m is not None:
                tgt[ax] = m
    dtype = dtype or values[0].dtype
    out = np.full((len(values), *tgt), pad_value, dtype=dtype)
    for i, v in enumerate(values):
        out[(i,) + tuple(slice(0, s) for s in v.shape)] = v
    return out


def _batch_is_full(batch_len: int, num_tokens: int, max_tokens: int, max_sentences: int) -> bool:
    if batch_len == 0:
        return False
    return batch_len == max_sentences or num_tokens > max_tokens


def batch_by_size(
    indices,
    num_tokens_fn,
    max_tokens: int | None = None,
    max_sentences: int | None = None,
    required_batch_size_multiple: int = 1,
) -> list[list[int]]:
    """Group ordered indices into token-budget batches (fairseq semantics).

    A batch closes when adding the next item would exceed ``max_tokens``
    (budget = batch_size * longest_item) or ``max_sentences``; on close the
    batch is trimmed to a multiple of ``required_batch_size_multiple`` and
    the remainder seeds the next batch.
    """
    max_tokens = max_tokens if max_tokens is not None else sys.maxsize
    max_sentences = max_sentences if max_sentences is not None else sys.maxsize
    bsz_mult = required_batch_size_multiple

    indices = list(indices)
    batches: list[list[int]] = []
    batch: list[int] = []
    sample_lens: list[int] = []
    longest = 0
    for idx in indices:
        n = num_tokens_fn(idx)
        sample_lens.append(n)
        longest = max(longest, n)
        assert longest <= max_tokens, (
            f"sentence at index {idx} of size {longest} exceeds max_tokens limit of {max_tokens}"
        )
        if _batch_is_full(len(batch), (len(batch) + 1) * longest, max_tokens, max_sentences):
            keep = max(bsz_mult * (len(batch) // bsz_mult), len(batch) % bsz_mult)
            batches.append(batch[:keep])
            batch = batch[keep:]
            sample_lens = sample_lens[keep:]
            longest = max(sample_lens) if sample_lens else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


def shape_bucket(length: int, multiple: int = 32, buckets: tuple[int, ...] | None = None) -> int:
    """Quantize a pad length to a static bucket boundary.

    With explicit ``buckets``, returns the smallest bucket >= length (last
    bucket if none fits — callers must truncate). Otherwise rounds up to
    ``multiple``.
    """
    if buckets:
        for b in buckets:
            if length <= b:
                return b
        return buckets[-1]
    return ((length + multiple - 1) // multiple) * multiple


def ordered_indices(sizes, shuffle: bool = True, sort_by_len: bool = True, seed: int = 1234):
    """Length-sorted shuffled index order:
    shuffle first, then stable mergesort by size, so equal lengths stay
    shuffled while batches stay length-homogeneous."""
    sizes = np.asarray(sizes)
    if shuffle:
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(sizes))
        if sort_by_len:
            order = order[np.argsort(sizes[order], kind="mergesort")]
    else:
        order = np.arange(len(sizes))
    return order
