"""The port's data-parallel helpers (``dicttts_tpu_torch/parallel/mesh.py``)
against the JAX package's mesh, and the rank's share of the randomness.

- ``pad_batch_to_devices`` gives the JAX function's arrays (zero rows at
  the end, 0-d entries kept), and ``shard_batch`` gives each rank the rows
  that the JAX ``shard_batch`` puts on that device of a 2-device mesh;
- ``TTSBatchProvider(..., devices_multiple=2)`` gives the JAX provider's
  batches with the same setting, on the repo's corpus;
- the trainer's generators fold the rank in: rank 0 draws what one
  process draws, rank 1 draws otherwise;
- the LSGAN terms' ``row_mean`` skips the zero rows that pad a batch to
  the world size, and the vocoder, whose losses have no row mask, refuses
  a batch size the ranks do not divide.
"""

import os

import numpy as np
import pytest
import torch

from dicttts_tpu.config import load_config
from dicttts_tpu.data import datasets as jdata
from dicttts_tpu.parallel import mesh as jmesh
from dicttts_tpu_torch import run
from dicttts_tpu_torch.data import datasets as tdata
from dicttts_tpu_torch.parallel import mesh
from dicttts_tpu_torch.train import losses
from dicttts_tpu_torch.train.trainer import Trainer

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORPUS = os.path.join(ROOT, ".prod_corpus", "binary")
RECIPE = os.path.join(ROOT, "dicttts_tpu", "configs", "datasets", "biaobei", "dict_tts.yaml")


def _batch(rows: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"word_tokens": rng.randint(1, 9, (rows, 5)).astype(np.int32),
            "mels": rng.randn(rows, 8, 3).astype(np.float32),
            "mel_lengths": rng.randint(1, 9, rows).astype(np.int32),
            "scale": np.float32(2.5)}


@pytest.mark.parametrize("rows,n", [(3, 2), (5, 4), (4, 2), (1, 8)])
def test_pad_matches_the_jax_package(rows, n):
    batch = _batch(rows)
    want = jmesh.pad_batch_to_devices(batch, n)
    got = mesh.pad_batch_to_devices(batch, n)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == want[k].dtype
    assert got["mels"].shape[0] % n == 0 and not got["mels"][rows:].any()


def test_shards_are_the_rows_the_jax_mesh_puts_on_each_device():
    batch = mesh.pad_batch_to_devices(_batch(3), 2)
    placed = jmesh.shard_batch(batch, jmesh.make_mesh(2))
    for r in range(2):
        got = mesh.shard_batch({**batch, "_meta": [{"i": i} for i in range(4)]}, world=2, index=r)
        for k in ("word_tokens", "mels", "mel_lengths"):
            shard = next(s for s in placed[k].addressable_shards if s.index[0].start == 2 * r)
            np.testing.assert_array_equal(got[k], np.asarray(shard.data), err_msg=k)
        assert got["scale"] == batch["scale"] and got["_meta"] == [{"i": 2 * r}, {"i": 2 * r + 1}]
    with pytest.raises(ValueError, match="multiple of the world size"):
        mesh.shard_batch(_batch(3), world=2, index=0)


@pytest.mark.parametrize("frame_refs", [False, True], ids=["streamed", "frame_refs"])
@pytest.mark.parametrize("max_sentences", [5, 60])
def test_the_provider_cuts_batches_as_the_jax_provider(max_sentences, frame_refs):
    cfg = {**load_config(RECIPE, save=False), "binary_data_dir": CORPUS, "max_sentences": max_sentences}
    batches = []
    for mod in (jdata, tdata):
        ds = mod.TTSBinaryDataset(CORPUS, "valid", cfg, "dict")
        provider = mod.TTSBatchProvider(ds, cfg, shuffle=True, devices_multiple=2,
                                        emit_frame_refs=frame_refs)
        batches.append(list(provider.train_batches()))
    want, got = batches
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "_meta":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the token budget closes batches at multiples of 2 (the last one may be odd)
    sizes = [int((b["mel_lengths"] > 0).sum()) for b in got]
    assert sum(sizes) == 18 and all(s % 2 == 0 for s in sizes[:-1])


def test_each_rank_draws_its_own_randomness(monkeypatch):
    trainer = Trainer("", seed=7, device="cpu")
    one = torch.rand(4, generator=trainer.step_generator(3))
    # rank 0 draws what a single process draws (its seed is unchanged)
    assert torch.equal(one, torch.rand(4, generator=torch.Generator().manual_seed(7 * 1_000_003 + 3)))
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    other = torch.rand(4, generator=trainer.step_generator(3))
    assert not torch.allclose(one, other)
    assert torch.equal(other, torch.rand(4, generator=trainer.step_generator(3)))  # reproducible
    assert not torch.allclose(other, torch.rand(4, generator=trainer.step_generator(4)))


def test_row_mean_skips_the_zero_rows_that_pad_a_batch():
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 3).astype(np.float32))
    lengths = torch.tensor([7, 5, 2, 0])  # the last row pads a batch of 3 to 4
    np.testing.assert_allclose(float(losses.row_mean(x, lengths)), float(x[:3].mean()), rtol=1e-6)
    full = torch.tensor([7, 5, 2, 1])
    np.testing.assert_allclose(float(losses.row_mean(x, full)), float(x.mean()), rtol=1e-6)
    assert float(losses.row_mean(x, torch.zeros(4, dtype=torch.int64))) == 0.0


def test_the_vocoder_refuses_a_batch_the_ranks_do_not_divide(tmp_path):
    (tmp_path / "train.idx").write_bytes(b"")
    cfg = {"task_cls": "dicttts_tpu_torch.train.tasks.hifigan.HifiGanTask", "binary_data_dir": str(tmp_path),
           "max_sentences": 6}
    with pytest.raises(ValueError, match="multiple of the 4 data-parallel ranks"):
        run.build_data_provider(cfg, 4)
