"""Port parity of the data pipeline (dicttts_tpu_torch.data, utils) against
the JAX package's, on the repo's binarized valid and test splits
(.prod_corpus/binary, 18 utterances each; the 494 MB dict_embed is never
read): items key for key, batches array for array and dtype for dtype in
streamed and frame-ref modes, the frame cache, and the device bank on a
small dict_embed written by the JAX package's IndexedDatasetBuilder (keys
compared as f32 of the same bf16 bits). Host-side helpers (collates,
batching, the f0 interpolation, the vocabulary, the record files, the
prefetch thread, the synthetic provider) are held against theirs too.
Everything here is exact: the port copies host code."""

import os
import pickle
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from dicttts_tpu.config import load_config
from dicttts_tpu.data import collate as jcollate
from dicttts_tpu.data import datasets as jdata
from dicttts_tpu.data.providers import SyntheticDictTTSProvider as JSynth
from dicttts_tpu.ops.pitch import norm_interp_f0 as jax_norm_interp_f0
from dicttts_tpu.utils import indexed_dataset as jidx
from dicttts_tpu.utils.prefetch import prefetch_iterator as jax_prefetch
from dicttts_tpu.utils.text_encoder import TokenTextEncoder as JEncoder
from dicttts_tpu_torch.data import collate as tcollate
from dicttts_tpu_torch.data import datasets as tdata
from dicttts_tpu_torch.data.providers import SyntheticDictTTSProvider as TSynth
from dicttts_tpu_torch.data.recordio import convert_indexed_dataset
from dicttts_tpu_torch.ops.pitch import norm_interp_f0
from dicttts_tpu_torch.utils import indexed_dataset as tidx
from dicttts_tpu_torch.utils.prefetch import prefetch_iterator
from dicttts_tpu_torch.utils.text_encoder import TokenTextEncoder

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORPUS = os.path.join(ROOT, ".prod_corpus", "binary")
RECIPE = os.path.join(ROOT, "dicttts_tpu", "configs", "datasets", "biaobei", "dict_tts.yaml")
SPLITS = ("valid", "test")
VARIANTS = {
    "recipe": {},  # max_tokens 20000, max_sentences 60, the recipe's buckets
    "small_batches": {"max_sentences": 4, "sentence_buckets": [4], "max_frames": 512,
                      "mel_buckets": [256, 512]},
    "pitch_amp": {"use_pitch_embed": True, "mel_transfer_f16": True, "max_tokens": 3000},
}


def _cfg(**over):
    return {**load_config(RECIPE, save=False), "binary_data_dir": CORPUS, **over}


def _assert_same(got, want, where=""):
    if isinstance(want, np.ndarray) or isinstance(want, np.generic):
        got = np.asarray(got)
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.mark.parametrize("variant", ["recipe", "pitch_amp"])
@pytest.mark.parametrize("split", SPLITS)
def test_items_match_the_jax_dataset(split, variant):
    cfg = _cfg(**VARIANTS[variant])
    want = jdata.TTSBinaryDataset(CORPUS, split, cfg, "dict")
    got = tdata.TTSBinaryDataset(CORPUS, split, cfg, "dict")
    assert len(got) == len(want) == 18 and got.sizes == want.sizes
    for i in range(len(want)):
        _assert_same(got[i], want[i], f"{split}[{i}]")
    _assert_same(got.light_item(3), want.light_item(3), "light_item")


@pytest.mark.parametrize("frame_refs", [False, True], ids=["streamed", "frame_refs"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("split", SPLITS)
def test_batches_match_the_jax_provider(split, variant, frame_refs):
    cfg = _cfg(**VARIANTS[variant])
    batches = []
    for mod in (jdata, tdata):
        ds = mod.TTSBinaryDataset(CORPUS, split, cfg, "dict")
        batches.append(list(mod.TTSBatchProvider(ds, cfg, shuffle=True,
                                                 emit_frame_refs=frame_refs).train_batches()))
    want, got = batches
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"batch {i}")
    if frame_refs:
        assert "mels" not in got[0] and got[0]["mel2word"].dtype == np.int16
    if variant == "small_batches":  # the last batch of 2 padded to the bucket of 4
        assert got[-1]["word_tokens"].shape[0] == 4 and got[-1]["mel_lengths"][-1] == 0


@pytest.mark.parametrize("variant", ["recipe", "pitch_amp"])
def test_frame_cache_matches_the_jax_cache(variant):
    cfg = _cfg(**VARIANTS[variant])
    want = jdata.TTSBinaryDataset(CORPUS, "valid", cfg, "dict").device_frame_cache()
    got = tdata.TTSBinaryDataset(CORPUS, "valid", cfg, "dict").device_frame_cache()
    _assert_same(got, want)
    assert got["mels"].shape == (18, 1548, 80)


def _bank_corpus(root, max_key=40, E=8, seed=0):
    """The valid split's word set and pinyin list, with a small dict_embed
    of every word id written by the JAX package's IndexedDatasetBuilder."""
    for f in ("word_set.json", "pinyin_encoder.pkl", "valid.idx", "valid.data", "valid_lengths.npy"):
        shutil.copy(os.path.join(CORPUS, f), root)
    with open(os.path.join(CORPUS, "pinyin_encoder.pkl"), "rb") as f:
        pinyin = pickle.load(f)
    rng = np.random.RandomState(seed)
    V = JEncoder.from_json(os.path.join(CORPUS, "word_set.json")).vocab_size
    with jidx.IndexedDatasetBuilder(os.path.join(root, "dict_embed")) as b:
        for i in range(V):
            n = max_key if i == 5 else rng.randint(1, max_key)
            ns = rng.randint(1, 4)
            b.add_item({"key": (rng.randn(n, E) * 3).astype(np.float32),
                        "value": np.zeros((n, E), np.float32),
                        "key_map": (np.arange(n) * ns // n + 1).astype(np.int64),
                        "pinyin": [pinyin[j] for j in rng.randint(1, len(pinyin), 2 * ns)],
                        "pinyin_map": np.repeat(np.arange(1, ns + 1), 2)})
    return str(root)


@pytest.mark.parametrize("limits", [(None, None), (24, 4)], ids=["bucketed", "max_gloss_pinyin"])
def test_device_bank_matches_the_jax_bank(tmp_path, limits):
    root = _bank_corpus(tmp_path)
    cfg = _cfg(binary_data_dir=root, device_bank_max_gloss=limits[0], device_bank_max_pinyin=limits[1])
    want = jdata.TTSBinaryDataset(root, "valid", cfg, "dict").device_bank(*limits)
    got = tdata.TTSBinaryDataset(root, "valid", cfg, "dict").device_bank(*limits)
    assert set(got) == set(want)
    assert got["keys"].dtype == torch.bfloat16 and want["keys"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(got["keys"].float().numpy(), np.asarray(want["keys"], np.float32))
    for k in ("key_map", "pinyin", "pinyin_map"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    L = limits[0] or 64  # the longest gloss (40) bucketed to 32
    assert tuple(got["keys"].shape) == (8000, L, 8)
    assert not got["keys"][[0, 1, 3]].any() and (got["key_map"][[0, 1, 3]] == 1).all()


def test_the_recipe_refuses_per_utterance_banks_and_rio_corpora(tmp_path):
    # per-utterance gathered banks are ported now (tests/test_torch_gathered_bank.py):
    # the dataset opens such a corpus and defers reading dict_embed to the first item
    ds = tdata.TTSBinaryDataset(CORPUS, "valid", _cfg(use_device_dict_bank=False), "dict")
    assert len(ds) == 18 and ds._dict_ds is None
    # .rio corpora are ported now (tests/test_torch_recordio.py): a split's
    # .rio is preferred, and one the native reader cannot open raises
    for name in ("word_set.json", "pinyin_encoder.pkl", "valid_lengths.npy"):
        os.symlink(os.path.join(CORPUS, name), tmp_path / name)
    (tmp_path / "valid.rio").write_bytes(b"")
    with pytest.raises(OSError, match="valid.rio"):
        tdata.TTSBinaryDataset(str(tmp_path), "valid", _cfg(), "dict")
    convert_indexed_dataset(os.path.join(CORPUS, "valid"), str(tmp_path / "valid"))
    rio = tdata.TTSBinaryDataset(str(tmp_path), "valid", _cfg(), "dict")
    assert len(rio) == 18 and rio.ds.is_native
    item, want = rio[5], tdata.TTSBinaryDataset(CORPUS, "valid", _cfg(), "dict")[5]
    assert set(item) == set(want) and all(np.array_equal(item[k], want[k]) for k in want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batching_helpers_match(seed):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(50, 600, 200)
    for shuffle in (True, False):
        np.testing.assert_array_equal(tcollate.ordered_indices(sizes, shuffle, seed=seed),
                                      jcollate.ordered_indices(sizes, shuffle, seed=seed))
    order = jcollate.ordered_indices(sizes, True, seed=seed)
    for mult in (1, 4):
        assert (tcollate.batch_by_size(order, lambda i: sizes[i], 4000, 16, mult)
                == jcollate.batch_by_size(order, lambda i: sizes[i], 4000, 16, mult))
    arrs = [rng.randn(rng.randint(1, 9), rng.randint(1, 5), 3) for _ in range(4)]
    np.testing.assert_array_equal(tcollate.collate_nd(arrs, max_lens=(10, 6, None)),
                                  jcollate.collate_nd(arrs, max_lens=(10, 6, None)))
    seqs = [rng.randint(0, 9, rng.randint(1, 7)) for _ in range(3)]
    np.testing.assert_array_equal(tcollate.collate_1d(seqs, shift_right=True),
                                  jcollate.collate_1d(seqs, shift_right=True))
    f0 = np.abs(rng.randn(80)).astype(np.float32) * 200 * (rng.rand(80) > 0.3)
    for norm in ("log", "standard"):
        for got, want in zip(norm_interp_f0(f0, norm, 100.0, 30.0),
                             jax_norm_interp_f0(f0, norm, 100.0, 30.0)):
            np.testing.assert_array_equal(got, want)


def test_text_encoder_matches():
    words = JEncoder.from_json(os.path.join(CORPUS, "word_set.json"))
    port = TokenTextEncoder.from_json(os.path.join(CORPUS, "word_set.json"))
    assert port.token_to_id == words.token_to_id and port.vocab_size == words.vocab_size == 8000
    text = "<BOS> 易 拍 unseen <EOS>"
    oov = TokenTextEncoder.from_json(os.path.join(CORPUS, "word_set.json"), replace_oov="<UNK>")
    ids = oov.encode(text)
    assert ids == JEncoder.from_json(os.path.join(CORPUS, "word_set.json"), replace_oov="<UNK>").encode(text)
    assert port.decode(ids + [0], strip_padding=True) == words.decode(ids + [0], strip_padding=True)


def test_record_files_read_across_packages(tmp_path):
    items = [{"a": np.arange(i + 1), "s": ["x", "y"][: i % 2 + 1], "n": i} for i in range(5)]
    for writer, reader, name in ((tidx, jidx, "port"), (jidx, tidx, "jax")):
        with writer.IndexedDatasetBuilder(str(tmp_path / name)) as b:
            for it in items:
                b.add_item(it)
        with reader.IndexedDataset(str(tmp_path / name)) as ds:
            assert len(ds) == 5
            for i, it in enumerate(items):
                _assert_same(ds[i], it, f"{name}[{i}]")


def test_prefetch_keeps_order_raises_and_stops():
    assert list(prefetch_iterator(range(50), depth=3)) == list(jax_prefetch(range(50), depth=3))

    def broken():
        yield 1
        raise KeyError("bad item")

    with pytest.raises(KeyError):
        list(prefetch_iterator(broken()))
    before = threading.active_count()
    it = prefetch_iterator(iter(range(10 ** 6)), depth=2)
    next(it)
    it.close()  # the trainer closes it when it stops early
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


@pytest.mark.parametrize("frame_refs", [False, True])
def test_synthetic_provider_matches(frame_refs):
    want, got = (cls(n_items=6, batch_size=4, emit_frame_refs=frame_refs) for cls in (JSynth, TSynth))
    for split in ("train_batches", "val_batches", "test_batches"):
        _assert_same(list(getattr(got, split)()), list(getattr(want, split)()), split)
    if frame_refs:
        _assert_same(got.ds.device_frame_cache(), want.ds.device_frame_cache())
