"""Port parity: dicttts_tpu_torch.ops.seq against dicttts_tpu.ops.seq, and
the port's data.collate.shape_bucket against the JAX package's. Integer
maps must agree exactly; the float gather is a copy, so it must agree
exactly too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.data.collate import shape_bucket as jax_shape_bucket
from dicttts_tpu.ops import seq as jseq
from dicttts_tpu_torch.data.collate import shape_bucket
from dicttts_tpu_torch.ops import seq as tseq

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)


def _durations(seed, B=3, T=7, max_dur=6):
    rng = np.random.RandomState(seed)
    dur = rng.randint(0, max_dur, (B, T)).astype(np.int32)
    nonpad = np.ones((B, T), np.float32)
    nonpad[1, 5:] = 0  # a padded row
    dur = (dur * nonpad).astype(np.int32)
    return dur, nonpad


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_frames", [16, 48])
def test_length_regulate(seed, max_frames):
    dur, nonpad = _durations(seed)
    ref = np.asarray(jseq.length_regulate(jnp.asarray(dur), max_frames, jnp.asarray(nonpad)))
    out = tseq.length_regulate(torch.tensor(dur), max_frames, torch.tensor(nonpad)).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


def test_length_regulate_all_zero_fallback():
    dur, nonpad = _durations(3)
    dur[0] = 0  # all-zero row: real tokens fall back to duration 1
    ref = np.asarray(jseq.length_regulate(jnp.asarray(dur), 32, jnp.asarray(nonpad)))
    out = tseq.length_regulate(torch.tensor(dur), 32, torch.tensor(nonpad)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[0, :8], [1, 2, 3, 4, 5, 6, 7, 0])


def test_length_regulate_without_nonpadding():
    dur, _ = _durations(4)
    ref = np.asarray(jseq.length_regulate(jnp.asarray(dur), 40))
    np.testing.assert_array_equal(tseq.length_regulate(torch.tensor(dur), 40).numpy(), ref)


@pytest.mark.parametrize("multiple", [1, 4, 5])
def test_pad_frames_multiple(multiple):
    dur, nonpad = _durations(5)
    m2w = np.asarray(jseq.length_regulate(jnp.asarray(dur), 30, jnp.asarray(nonpad)))
    ref = np.asarray(jseq.pad_frames_multiple(jnp.asarray(m2w), multiple))
    out = tseq.pad_frames_multiple(torch.tensor(m2w), multiple).numpy()
    np.testing.assert_array_equal(out, ref)


def test_gather_expand_and_sequence_mask():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 3).astype(np.float32)
    m2w = rng.randint(0, 6, (2, 11)).astype(np.int32)
    ref = np.asarray(jseq.gather_expand(jnp.asarray(x), jnp.asarray(m2w)))
    out = tseq.gather_expand(torch.tensor(x), torch.tensor(m2w)).numpy()
    np.testing.assert_array_equal(out, ref)
    lengths = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(
        tseq.sequence_mask(torch.tensor(lengths), 7).numpy(),
        np.asarray(jseq.sequence_mask(jnp.asarray(lengths), 7)))


@pytest.mark.parametrize("length,multiple,buckets", [
    (1, 8, None), (8, 8, None), (9, 8, None), (100, 64, None),
    (5, 32, (16, 32)), (20, 32, (16, 32)), (40, 32, (16, 32)),
])
def test_shape_bucket(length, multiple, buckets):
    assert shape_bucket(length, multiple, buckets) == jax_shape_bucket(length, multiple, buckets)
