"""Port parity of the ``.rio`` record format (``dicttts_tpu_torch/data/
recordio.py``) against ``dicttts_tpu/data/recordio.py``, and the port's
corpus reading from it. Everything here is exact (bytes, arrays, batches).

- a record encodes to the JAX package's bytes and decodes back;
- a split written by the JAX package's writer (the repo's valid split)
  reads back in the port, natively and through the Python reader, item
  for item equal to the ``.data`` split; a split the port converts reads
  back in the JAX package, and the two files are the same bytes;
- the port's native reader is built from its own copy of the C++ source
  into its own build directory, and a failed build raises;
- the port's batches from a ``.rio`` split equal its batches from the
  ``.data`` split, with the native reader asked to prefetch.
"""

import os
import re

import numpy as np
import pytest

from dicttts_tpu.data import recordio as jrio
from dicttts_tpu.utils.indexed_dataset import IndexedDataset as JIndexed
from dicttts_tpu_torch.data import recordio as rio
from dicttts_tpu_torch.data.datasets import TTSBatchProvider, TTSBinaryDataset
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORPUS = os.path.join(ROOT, ".prod_corpus", "binary")
SPLIT = os.path.join(CORPUS, "valid")


def _equal(got: dict, want: dict):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def _items(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [{"mel": rng.randn(rng.randint(5, 30), 80).astype(np.float32),
             "phone": rng.randint(0, 50, size=rng.randint(3, 12)).astype(np.int64),
             "mel2word": rng.randint(0, 9, 17).astype(np.int16), "f16": np.ones(3, np.float16),
             "flag": np.bool_(i % 2), "item_name": f"it{i:03d}", "sec": float(i) * 0.5,
             "words": ["<BOS>", "好", "<EOS>"], "spk_id": i} for i in range(n)]


def test_records_are_the_jax_bytes_and_round_trip():
    for item in _items():
        data = rio.encode_record(item)
        assert data == jrio.encode_record(item)
        got = rio.decode_record(memoryview(data))
        _equal(got, {**item, "flag": bool(item["flag"])})


@pytest.mark.parametrize("use_native", [True, False])
def test_readers_round_trip_and_agree(tmp_path, use_native):
    path = str(tmp_path / "c")
    items = _items(9)
    with rio.RecordWriter(path) as w:
        for it in items:
            w.add(it)
    r = rio.RecordReader(path, use_native=use_native)
    assert r.is_native == use_native and len(r) == 9
    r.prefetch([1, 2, 3])
    for i in (0, 8, 3):
        _equal(r[i], {**items[i], "flag": bool(items[i]["flag"])})
    with pytest.raises(IndexError):
        r[9]
    r.close()


def test_port_reads_a_jax_written_split(tmp_path):
    """The JAX package's writer, given the items as the port's converter
    stores them, writes the bytes the port's converter writes; both readers
    of the port read them back equal to the .data split."""
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    with jrio.RecordWriter(jpath) as w:
        for item in JIndexed(SPLIT):
            w.add(rio.record_item(item))
    n = rio.convert_indexed_dataset(SPLIT, ppath)
    for ext in (".rio", ".rix"):
        with open(jpath + ext, "rb") as a, open(ppath + ext, "rb") as b:
            assert a.read() == b.read(), ext
    src = IndexedDataset(SPLIT)
    native, python = rio.RecordReader(jpath), rio.RecordReader(jpath, use_native=False)
    assert len(native) == len(python) == len(src) == n > 0
    for i in range(n):
        want = rio.record_item(src[i])
        _equal(native[i], want)
        _equal(python[i], want)
        assert native[i]["words"] == src[i]["words"]


def test_jax_reads_a_port_written_split(tmp_path):
    path = str(tmp_path / "port")
    n = rio.convert_indexed_dataset(SPLIT, path)
    src = IndexedDataset(SPLIT)
    for use_native in (None, False):  # the JAX package's native library where it is built
        r = jrio.RecordReader(path, use_native=use_native)
        assert len(r) == n
        for i in range(n):
            _equal(r[i], rio.record_item(src[i]))


def test_the_jax_converter_fails_on_the_corpus(tmp_path):
    """Why the port's converter keeps lists of strings as lists (ROADMAP
    Queue 3): the JAX one turns ``words`` into a numpy string array, which
    the format has no dtype code for."""
    with pytest.raises(KeyError):
        jrio.convert_indexed_dataset(SPLIT, str(tmp_path / "j"))


def test_the_native_reader_is_the_ports_own_build(tmp_path, monkeypatch):
    so = rio.build()
    pkg = os.path.realpath(os.path.join(ROOT, "dicttts_tpu_torch"))
    assert os.path.realpath(so).startswith(os.path.join(pkg, "_build") + os.sep)
    assert os.path.realpath(rio.SOURCE) == os.path.join(pkg, "csrc", "recordio.cpp")
    assert os.path.realpath(rio.native_lib()._name) == os.path.realpath(so)
    # no source of the port names the JAX package's native directory
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                text = open(os.path.join(dirpath, f), encoding="utf-8").read()
                assert not re.search(r"native/|librecordio\.so|['\"]native['\"]", text), f
    monkeypatch.setattr(rio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native .rio reader"):
        rio.build()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(rio, "SOURCE", broken)
    monkeypatch.setenv("CXX", "g++")
    with pytest.raises(RuntimeError, match="failed to build"):
        rio.build()


def test_batches_from_rio_equal_batches_from_data(tmp_path, monkeypatch):
    """The port's dataset prefers <split>.rio, asks the native reader to
    prefetch the next batch, and its batches (streamed mels, and frame refs
    with the frame cache) equal those of the .data split."""
    data_dir = tmp_path / "binary"
    data_dir.mkdir()
    for name in ("word_set.json", "pinyin_encoder.pkl", "valid_lengths.npy", "valid.data", "valid.idx"):
        os.symlink(os.path.join(CORPUS, name), data_dir / name)
    rio_dir = tmp_path / "binary_rio"
    rio_dir.mkdir()
    for name in ("word_set.json", "pinyin_encoder.pkl", "valid_lengths.npy"):
        os.symlink(os.path.join(CORPUS, name), rio_dir / name)
    rio.convert_indexed_dataset(SPLIT, str(rio_dir / "valid"))
    cfg = {"max_tokens": 4000, "max_sentences": 6, "max_frames": 1548, "use_device_dict_bank": True,
           "mel_buckets": [512, 768, 1024, 1548], "txt_buckets": [64], "sentence_buckets": [6],
           "frames_multiple": 4, "use_dict": True}
    prefetched = []
    prefetch = rio.RecordReader.prefetch
    monkeypatch.setattr(rio.RecordReader, "prefetch",
                        lambda self, ids: (prefetched.append(list(ids)), prefetch(self, ids)))
    for frame_refs in (False, True):
        want_ds = TTSBinaryDataset(str(data_dir), "valid", cfg)
        got_ds = TTSBinaryDataset(str(rio_dir), "valid", cfg)
        assert isinstance(got_ds.ds, rio.RecordReader) and got_ds.ds.is_native
        assert isinstance(want_ds.ds, IndexedDataset)
        want = list(TTSBatchProvider(want_ds, cfg, shuffle=True, emit_frame_refs=frame_refs).train_batches())
        got = list(TTSBatchProvider(got_ds, cfg, shuffle=True, emit_frame_refs=frame_refs).train_batches())
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.pop("_meta") == w.pop("_meta")
            _equal(g, w)
        _equal(got_ds.device_frame_cache(max_frames=1548), want_ds.device_frame_cache(max_frames=1548))
    assert len(prefetched) == 2 * (len(got) - 1)
