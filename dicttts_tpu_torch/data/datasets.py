"""The binarized corpus: items, the device bank, the frame cache, batches.

Port of ``TTSBinaryDataset`` and ``TTSBatchProvider`` from
``dicttts_tpu/data/datasets.py``, reading the same ``.data``/``.idx``
binaries the binarizer writes, or a split's ``.rio``/``.rix`` records
where they exist (``data/recordio.py``, read by the native reader, which
the provider asks to prefetch the next batch's records):

- ``TTSBinaryDataset`` gives one utterance's arrays (kinds 'base', 'fs',
  'word', 'dict'): mel, phone tokens, mel2ph, f0/uv (``use_pitch_embed``),
  words, word tokens, ph2word, mel2word, sandhi ``pron_modified``. With
  ``use_device_dict_bank`` (the recipe) items carry word ids only, and
  ``device_bank`` builds the whole ``[V, L, E]`` dict bank once; without
  it each 'dict' item carries its own gathered bank (``_dict_bank``: keys,
  values, maps, one row per word, zero BOS/EOS rows with maps 1).
  ``device_frame_cache`` builds the split's ``[N, T, 80]`` mels once.
- ``TTSBatchProvider`` does the length-sorted token-budget batching and
  pads every batch to the configured bucket shapes, so its batches are the
  JAX package's, array for array. With ``emit_frame_refs`` the batches
  carry ``item_idx`` in place of the mels (the task gathers them from the
  frame cache) and ``mel2word`` as int16. Gathered banks are padded to the
  gloss bucket (32, or ``gloss_buckets``) and the pinyin bucket (8, or
  ``pinyin_buckets``).
- ``VocoderDataset`` gives HiFi-GAN's batches of wav crops and their mel
  windows, with the JAX package's ``np.random.RandomState`` streams, so its
  batches are the JAX package's too.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

import numpy as np
import torch

from dicttts_tpu_torch.data.collate import (
    batch_by_size,
    collate_1d,
    collate_2d,
    collate_nd,
    ordered_indices,
    shape_bucket,
)
from dicttts_tpu_torch.data.recordio import RecordReader
from dicttts_tpu_torch.ops.pitch import norm_interp_f0
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset
from dicttts_tpu_torch.utils.text_encoder import TokenTextEncoder


def transfer_mel_dtype(cfg: dict):
    """The mels' host-to-device dtype: float16 under amp (or
    ``mel_transfer_f16``), else float32."""
    return np.float16 if cfg.get("mel_transfer_f16", bool(cfg.get("amp"))) else np.float32


def utterance_bank(dict_ds, token_to_id: dict, pinyin_list: list, words: list, read_values: bool,
                   int_dtype=np.int32) -> tuple[dict, list]:
    """The gathered bank of one utterance, by the rule the training collater
    and the inferencer share: a row per word from ``dict_embed`` (keys, and
    values where ``read_values``, [n, L, E] f32; key_map [n, L]; pinyin ids
    and pinyin_map [n, P] in ``int_dtype``), padded with zeros to the
    utterance's widest entry, then a zero BOS and EOS row with maps 1, as
    the collater of the upstream recipe pads them. Returns it and the
    words' tokens_gloss."""
    rows = {k: [] for k in ("keys", "key_map", *(("values",) if read_values else ()), "pinyin", "pinyin_map")}
    tokens_gloss = []
    for word in words:
        e = dict_ds[token_to_id.get(word, 2)]
        rows["keys"].append(np.asarray(e["key"], np.float32))
        rows["key_map"].append(np.asarray(e["key_map"], int_dtype))
        if read_values:
            rows["values"].append(np.asarray(e["value"], np.float32))
        rows["pinyin"].append(np.asarray([pinyin_list.index(p) for p in e["pinyin"]], int_dtype))
        rows["pinyin_map"].append(np.asarray(e["pinyin_map"], int_dtype))
        tokens_gloss.append(e.get("tokens_gloss"))
    out = {}
    for k, v in rows.items():  # BOS/EOS rows: zero floats and ids, maps 1
        v = collate_2d(v) if v[0].ndim == 2 else collate_1d(v)
        pad = ((1, 1),) + ((0, 0),) * (v.ndim - 1)
        out[k] = np.pad(v, pad, constant_values=1 if k.endswith("_map") else 0)
    return out, tokens_gloss


class TTSBinaryDataset:
    def __init__(self, data_dir: str, prefix: str, cfg: dict, kind: str = "dict"):
        self.data_dir = data_dir
        self.prefix = prefix
        self.cfg = cfg
        self.kind = kind
        base = os.path.join(data_dir, prefix)
        # the split's .rio records where they exist, as the JAX dataset prefers them
        self.ds = RecordReader(base) if os.path.exists(base + ".rio") else IndexedDataset(base)
        sizes_fn = os.path.join(data_dir, f"{prefix}_lengths.npy")
        self.sizes = (
            np.load(sizes_fn).tolist()
            if os.path.exists(sizes_fn)
            else [len(self.ds[i]["mel"]) for i in range(len(self.ds))]
        )
        self._light_cache: dict = {}
        self._dict_ds: Optional[IndexedDataset] = None  # dict_embed, opened at the first gathered bank
        self._word_encoder: Optional[TokenTextEncoder] = None
        self._pinyin_list: Optional[list] = None
        if kind == "dict" and cfg.get("use_dict", True):
            with open(os.path.join(data_dir, "word_set.json")) as f:
                self._word_encoder = TokenTextEncoder(json.load(f), replace_oov="<UNK>")
            with open(os.path.join(data_dir, "pinyin_encoder.pkl"), "rb") as f:
                self._pinyin_list = pickle.load(f)

    def __len__(self):
        return len(self.ds)

    def device_bank(self, max_gloss: int | None = None, max_pinyin: int | None = None,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
        """The whole vocabulary's dict bank, read from ``dict_embed``:
        {'keys' [V, L, E] in ``dtype`` (bf16, the recipe's), 'key_map'
        [V, L], 'pinyin' [V, P], 'pinyin_map' [V, P] int32}, CPU tensors.
        L is the longest gloss bucketed to 32 and P the most pinyin tokens
        bucketed to 8, unless given. Rows 0 (pad), <BOS> and <EOS> follow
        the collater's convention: zero keys, maps 1."""
        V = self._word_encoder.vocab_size
        with IndexedDataset(os.path.join(self.data_dir, "dict_embed")) as dict_ds:
            entries = [dict_ds[i] for i in range(V)]
        L = max_gloss or shape_bucket(max(np.asarray(e["key"]).shape[0] for e in entries), 32)
        P = max_pinyin or shape_bucket(max(len(e["pinyin"]) for e in entries), 8)
        E = np.asarray(entries[0]["key"]).shape[-1]
        pinyin_id: dict = {}
        for i, p in enumerate(self._pinyin_list):
            pinyin_id.setdefault(p, i)  # the first match, as list.index finds it
        bank = {
            "keys": torch.zeros((V, L, E), dtype=dtype),
            "key_map": torch.zeros((V, L), dtype=torch.int32),
            "pinyin": torch.zeros((V, P), dtype=torch.int32),
            "pinyin_map": torch.zeros((V, P), dtype=torch.int32),
        }
        for i, e in enumerate(entries):
            k = np.asarray(e["key"], np.float32)[:L]
            bank["keys"][i, : len(k)] = torch.from_numpy(k)  # f32 -> dtype, round to nearest even
            km = np.asarray(e["key_map"], np.int32)[:L]
            bank["key_map"][i, : len(km)] = torch.from_numpy(km)
            py = np.asarray([pinyin_id[p] for p in e["pinyin"]], np.int32)[:P]
            bank["pinyin"][i, : len(py)] = torch.from_numpy(py)
            pm = np.asarray(e["pinyin_map"], np.int32)[:P]
            bank["pinyin_map"][i, : len(pm)] = torch.from_numpy(pm)
        special = [0] + [
            self._word_encoder.token_to_id[t]
            for t in ("<BOS>", "<EOS>")
            if t in self._word_encoder.token_to_id
        ]
        for i in special:
            bank["keys"][i] = 0
            bank["key_map"][i] = 1
            bank["pinyin"][i] = 0
            bank["pinyin_map"][i] = 1
        return bank

    def device_frame_cache(self, max_frames: int | None = None, mel_dtype=None) -> dict:
        """The split's per-frame arrays, indexed by item: {'mels' [N, T, 80]}
        in the collater's transfer dtype (so a gathered batch equals a
        streamed one bit for bit), plus {'f0', 'uv' [N, T]} float32 with
        ``use_pitch_embed``; zero past each item's length. Numpy arrays."""
        cfg = self.cfg
        T = int(max_frames or cfg.get("max_frames", 1548))
        if mel_dtype is None:
            mel_dtype = transfer_mel_dtype(cfg)
        N = len(self.ds)
        n_mels = int(cfg.get("audio_num_mel_bins", 80))
        use_pitch = bool(cfg.get("use_pitch_embed"))
        cache = {"mels": np.zeros((N, T, n_mels), mel_dtype)}
        if use_pitch:
            cache["f0"] = np.zeros((N, T), np.float32)
            cache["uv"] = np.zeros((N, T), np.float32)
        for i in range(N):
            item = self.ds[i]
            mel = np.asarray(item["mel"], np.float32)[:T]
            cache["mels"][i, : len(mel)] = mel.astype(mel_dtype)
            if use_pitch and "f0" in item:
                f0, uv = norm_interp_f0(np.asarray(item["f0"])[: len(mel)], cfg.get("pitch_norm", "log"))
                cache["f0"][i, : len(f0)] = f0
                cache["uv"][i, : len(uv)] = uv
        return cache

    def light_item(self, index: int) -> dict:
        """An item without its per-frame float arrays (mels, f0, uv), for
        frame-ref batches, memoized: later epochs skip the record's decode."""
        cached = self._light_cache.get(index)
        if cached is None:
            s = self[index]
            for k in ("mels", "f0", "uv"):
                s.pop(k, None)
            self._light_cache[index] = cached = s
        return cached

    def _dict_bank(self, words: list) -> dict:
        """The gathered bank of one utterance (``utterance_bank``) over
        words[1:-1], keys and values both read, with its tokens_gloss."""
        if self._dict_ds is None:
            self._dict_ds = IndexedDataset(os.path.join(self.data_dir, "dict_embed"))
        out, tokens_gloss = utterance_bank(self._dict_ds, self._word_encoder.token_to_id, self._pinyin_list,
                                           words[1:-1], read_values=True)
        out["tokens_gloss"] = tokens_gloss
        return out

    def __getitem__(self, index: int) -> dict:
        item = self.ds[index]
        cfg = self.cfg
        max_frames = cfg.get("max_frames", 1548)
        mel = np.asarray(item["mel"], np.float32)[:max_frames]
        T = len(mel)
        sample = {
            "_idx": np.int32(index),
            "item_name": item.get("item_name", str(index)),
            "txt": item.get("txt", ""),
            "txt_tokens": np.asarray(item["phone"] if "phone" in item else item["txt_token"], np.int64)[
                : cfg.get("max_input_tokens", 1550)
            ],
            "mels": mel,
            "mel_lengths": np.int32(T),
        }
        if self.kind in ("fs", "word", "dict"):
            if "mel2ph" in item:
                sample["mel2ph"] = np.asarray(item["mel2ph"], np.int64)[:T]
            if cfg.get("use_pitch_embed") and "f0" in item:
                f0, uv = norm_interp_f0(np.asarray(item["f0"])[:T], cfg.get("pitch_norm", "log"))
                sample["f0"], sample["uv"] = f0, uv
        if cfg.get("use_spk_id"):
            sample["spk_ids"] = np.int64(item.get("spk_id", 0))
        if self.kind in ("word", "dict"):
            sample["words"] = item["words"]
            sample["word_tokens"] = np.asarray(item["word_tokens"], np.int64)
            sample["word_lengths"] = np.int32(len(item["word_tokens"]))
            sample["mel2word"] = np.asarray(item["mel2word"], np.int64)[:T]
            sample["ph2word"] = np.asarray(item["ph2word"], np.int64)[: cfg.get("max_input_tokens", 1550)]
            if "pron_modified" in item:
                sample["pron_modified"] = np.asarray(item["pron_modified"], np.int64)
        if self.kind == "dict" and self._word_encoder is not None and not cfg.get("use_device_dict_bank"):
            sample.update(self._dict_bank(item["words"]))
        return sample


class TTSBatchProvider:
    """Token-budget batches padded to the configured bucket shapes."""

    NON_ARRAY_KEYS = ("item_name", "txt", "words", "tokens_gloss")

    def __init__(self, dataset: TTSBinaryDataset, cfg: dict, shuffle: bool = True,
                 emit_frame_refs: bool = False, devices_multiple: int = 1):
        self.ds = dataset
        self.cfg = cfg
        self.shuffle = shuffle
        self.emit_frame_refs = emit_frame_refs
        # data parallelism: a closing batch is cut to a multiple of the ranks
        self.devices_multiple = devices_multiple

    def _make_batches(self):
        sizes = self.ds.sizes
        order = ordered_indices(
            sizes, shuffle=self.shuffle, sort_by_len=self.cfg.get("sort_by_len", True),
            seed=self.cfg.get("seed", 1234),
        )
        min_frames = self.cfg.get("min_frames", 0)
        order = [i for i in order if sizes[i] >= min_frames]
        return batch_by_size(
            order,
            lambda i: min(sizes[i], self.cfg.get("max_frames", 1548)),
            max_tokens=self.cfg.get("max_tokens", 30000),
            max_sentences=self.cfg.get("max_sentences", 100000),
            required_batch_size_multiple=self.devices_multiple,
        )

    def collate(self, samples: list[dict]) -> dict:
        cfg = self.cfg
        txt_b = tuple(cfg.get("txt_buckets", ())) or None
        mel_b = tuple(cfg.get("mel_buckets", ())) or None
        t_txt = shape_bucket(max(len(s["txt_tokens"]) for s in samples), 16, txt_b)
        # mel_lengths is the truncated mel's length, so the bucket is the same
        # whether or not the sample carries the mel (light_item drops it)
        t_mel = shape_bucket(max(int(s["mel_lengths"]) for s in samples), 64, mel_b)
        fm = cfg.get("frames_multiple", 1)
        t_mel = ((t_mel + fm - 1) // fm) * fm
        batch = {
            "txt_tokens": collate_1d(
                [s["txt_tokens"][:t_txt] for s in samples], max_len=t_txt, dtype=np.int32
            ),
            "mel_lengths": np.asarray([min(int(s["mel_lengths"]), t_mel) for s in samples], np.int32),
            "txt_lengths": np.asarray([min(len(s["txt_tokens"]), t_txt) for s in samples], np.int32),
        }
        if self.emit_frame_refs:
            batch["item_idx"] = np.asarray([int(s["_idx"]) for s in samples], np.int32)
        else:
            batch["mels"] = collate_2d(
                [s["mels"][:t_mel] for s in samples], max_len=t_mel, dtype=transfer_mel_dtype(cfg)
            )
            for key in ("f0", "uv"):
                if key in samples[0]:
                    batch[key] = collate_1d([s[key][:t_mel] for s in samples], max_len=t_mel)
        # frame-ref batches carry only the alignment their task reads, as
        # int16 (word and phone indices stay below the text buckets); the
        # [B, T_mel] array also carries the batch's mel bucket to the task
        align_keys = ("mel2ph", "mel2word")
        if self.emit_frame_refs and "mel2word" in samples[0]:
            align_keys = ("mel2word",)
        align_dtype = np.int16 if self.emit_frame_refs else np.int32
        for key in align_keys:
            if key in samples[0]:
                batch[key] = collate_1d(
                    [s[key][:t_mel] for s in samples], max_len=t_mel, dtype=align_dtype
                )
        if "spk_ids" in samples[0]:
            batch["spk_ids"] = np.asarray([int(s["spk_ids"]) for s in samples], np.int32)
        batch["_meta"] = [
            {k: s.get(k) for k in self.NON_ARRAY_KEYS if k in s} for s in samples
        ]
        if "word_tokens" in samples[0]:
            t_w = shape_bucket(max(len(s["word_tokens"]) for s in samples), 16, txt_b)
            batch["word_tokens"] = collate_1d(
                [s["word_tokens"][:t_w] for s in samples], max_len=t_w, dtype=np.int32
            )
            batch["ph2word"] = collate_1d(
                [s["ph2word"][:t_txt] for s in samples], max_len=t_txt, dtype=np.int32
            )
            batch["word_lengths"] = np.asarray(
                [min(int(s["word_lengths"]), t_w) for s in samples], np.int32
            )
            if "pron_modified" in samples[0]:
                batch["pron_modified"] = collate_1d(
                    [s["pron_modified"][:t_w] for s in samples], max_len=t_w, dtype=np.int32
                )
            if "keys" in samples[0]:
                # the gloss and pinyin axes are bucketed too, so that batches
                # fall into a few shapes
                l_k = shape_bucket(max(s["keys"].shape[1] for s in samples), 32,
                                   tuple(cfg.get("gloss_buckets", ())) or None)
                l_p = shape_bucket(max(s["pinyin"].shape[1] for s in samples), 8,
                                   tuple(cfg.get("pinyin_buckets", ())) or None)
                for key in ("keys", "values"):
                    batch[key] = collate_nd([s[key][:t_w, :l_k] for s in samples],
                                            max_lens=(t_w, l_k, None), dtype=np.float32)
                batch["key_map"] = collate_nd([s["key_map"][:t_w, :l_k] for s in samples],
                                              max_lens=(t_w, l_k), dtype=np.int32)
                for key in ("pinyin", "pinyin_map"):
                    batch[key] = collate_nd([s[key][:t_w, :l_p] for s in samples],
                                            max_lens=(t_w, l_p), dtype=np.int32)
        return batch

    def _pad_sentence_bucket(self, batch: dict) -> dict:
        """Pad the sentence axis up to the smallest of ``sentence_buckets``
        that holds it. Pad rows are all zero: item_idx 0 with mel_lengths 0,
        whose gathered mels the task masks to zero."""
        buckets = self.cfg.get("sentence_buckets") or None
        if not buckets:
            return batch
        n = int(np.shape(batch["txt_tokens"])[0])
        fit = [b for b in sorted(buckets) if b >= n]
        if not fit or fit[0] == n:
            return batch
        pad = fit[0] - n
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
                out[k] = np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
            else:
                out[k] = v
        return out

    def _iter(self):
        get = self.ds.light_item if self.emit_frame_refs else self.ds.__getitem__
        batches = self._make_batches()
        prefetch = getattr(self.ds.ds, "prefetch", None)  # the .rio reader's
        for n, idx_batch in enumerate(batches):
            if prefetch is not None and n + 1 < len(batches):
                prefetch(batches[n + 1])  # warm the next batch's pages
            if idx_batch:
                yield self._pad_sentence_bucket(self.collate([get(i) for i in idx_batch]))

    def train_batches(self):
        return self._iter()

    def val_batches(self):
        return self._iter()

    def test_batches(self):
        return self._iter()


class VocoderDataset:
    """Batches of ``batch_size`` random crops: ``max_samples`` wav samples
    and their ``max_samples // hop`` mel frames, from binaries written
    ``with_wav`` (upstream tasks/vocoder/dataset_utils.py:49-177).

    Training batches shuffle and crop from one RandomState(seed) that
    advances across epochs; validation and test batches go in order, each
    item cropped at an offset fixed by RandomState(seed + 7919 * (j + 1)),
    so two validations of one model agree. Clips shorter than the window
    are right-padded with zeros. A last partial batch is dropped."""

    def __init__(self, data_dir: str, prefix: str, cfg: dict, batch_size: int = 24, seed: int = 1234):
        self.ds = IndexedDataset(os.path.join(data_dir, prefix))
        self.cfg = cfg
        self.batch_size = batch_size
        self.hop = cfg.get("hop_size", 256)
        self.max_samples = cfg.get("max_samples", 8192)
        self.seed = seed
        self.rng = np.random.RandomState(seed)

    def _crop(self, item, rng) -> tuple[np.ndarray, np.ndarray]:
        if item.get("wav") is None:
            raise ValueError(f"item {item.get('item_name')!r} carries no wav: binarize the corpus with "
                             "with_wav=true")
        wav = np.asarray(item["wav"], np.float32)
        mel = np.asarray(item["mel"], np.float32)
        mel_win = self.max_samples // self.hop
        start = rng.randint(0, mel.shape[0] - mel_win) if mel.shape[0] > mel_win else 0
        mel_c = mel[start:start + mel_win]
        wav_c = wav[start * self.hop:(start + mel_win) * self.hop]
        if mel_c.shape[0] < mel_win:
            mel_c = np.pad(mel_c, ((0, mel_win - mel_c.shape[0]), (0, 0)))
            wav_c = np.pad(wav_c, (0, self.max_samples - len(wav_c)))
        return wav_c, mel_c

    def _batches(self, deterministic: bool = False):
        if deterministic:
            order = np.arange(len(self.ds))

            def rng_for(j):
                return np.random.RandomState(self.seed + 7919 * (int(j) + 1))
        else:
            order = self.rng.permutation(len(self.ds))

            def rng_for(j):
                return self.rng
        for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
            wavs, mels = zip(*[self._crop(self.ds[j], rng_for(j)) for j in order[i:i + self.batch_size]])
            yield {"wavs": np.stack(wavs), "mels": np.stack(mels)}

    def train_batches(self):
        return self._batches()

    def val_batches(self):
        return self._batches(deterministic=True)

    def test_batches(self):
        return self._batches(deterministic=True)
