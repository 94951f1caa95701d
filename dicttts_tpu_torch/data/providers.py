"""A small synthetic corpus with the batch provider's interface.

Port of ``dicttts_tpu/data/providers.py``: ``SyntheticDictTTSProvider``
builds a deterministic toy corpus (words with fixed durations,
word-dependent mel patterns, a toy dictionary bank); with
``emit_frame_refs`` its batches carry ``item_idx`` and its ``.ds`` offers
``device_frame_cache``, as ``TTSBatchProvider``'s do. The binary-backed
provider is in ``data/datasets.py``.
"""

from __future__ import annotations

import numpy as np


class SyntheticDictTTSProvider:
    def __init__(
        self,
        n_items: int = 16,
        batch_size: int = 8,
        word_vocab: int = 50,
        t_words: int = 8,
        l_gloss: int = 6,
        l_pinyin: int = 4,
        embed_dim: int = 16,
        pinyin_vocab: int = 20,
        max_frames: int = 48,
        seed: int = 0,
        emit_frame_refs: bool = False,
    ):
        rng = np.random.RandomState(seed)
        self.batch_size = batch_size
        # mirror TTSBatchProvider's device-frame-cache contract: batches
        # carry item_idx, and tasks resolve mels from .ds.device_frame_cache
        self.emit_frame_refs = emit_frame_refs
        self.max_frames = max_frames
        if emit_frame_refs:
            provider = self

            class _DS:
                def device_frame_cache(self, max_frames=None, mel_dtype=np.float16):
                    T = int(max_frames or provider.max_frames)
                    mels = np.stack([it["mels"][:T] for it in provider.items])
                    return {"mels": mels.astype(mel_dtype)}

            self.ds = _DS()
        self.items = []
        # a fixed toy dictionary: every word has 2 senses, 3 gloss tokens each
        self.gloss_bank = rng.randn(word_vocab, l_gloss, embed_dim).astype(np.float32)
        self.pinyin_bank = rng.randint(1, pinyin_vocab, size=(word_vocab, l_pinyin))
        # every word has 2 senses: first half of gloss/pinyin tokens sense 1,
        # second half sense 2 (generalizes to any l_gloss/l_pinyin)
        key_map_row = ((np.arange(l_gloss) >= l_gloss // 2) + 1).astype(np.int64)
        pinyin_map_row = ((np.arange(l_pinyin) >= l_pinyin // 2) + 1).astype(np.int64)
        for _ in range(n_items):
            n_words = rng.randint(4, t_words + 1)
            words = rng.randint(3, word_vocab, size=t_words)
            words[n_words:] = 0
            durs = rng.randint(4, 9, size=t_words)
            durs[n_words:] = 0
            total = min(int(durs.sum()), max_frames)
            mel2word = np.zeros(max_frames, np.int32)
            pos = 0
            for w in range(n_words):
                for _ in range(durs[w]):
                    if pos >= max_frames:
                        break
                    mel2word[pos] = w + 1
                    pos += 1
            # word-dependent mel pattern (learnable mapping)
            mels = np.zeros((max_frames, 80), np.float32)
            for f in range(total):
                w = words[mel2word[f] - 1]
                mels[f] = np.sin(np.arange(80) * (w + 1) * 0.01) + 0.1
            self.items.append(
                dict(
                    word_tokens=words.astype(np.int32),
                    keys=self.gloss_bank[words] * (words > 0)[:, None, None],
                    values=self.gloss_bank[words] * (words > 0)[:, None, None],
                    key_map=(np.tile(key_map_row, (t_words, 1)) * (words > 0)[:, None]).astype(np.int32),
                    pinyin=(self.pinyin_bank[words] * (words > 0)[:, None]).astype(np.int32),
                    pinyin_map=(np.tile(pinyin_map_row, (t_words, 1)) * (words > 0)[:, None]).astype(np.int32),
                    pron_modified=np.zeros(t_words, np.int32),
                    mel2word=mel2word,
                    mels=mels,
                    word_lengths=np.int32(n_words),
                    mel_lengths=np.int32(total),
                )
            )

    def _batches(self, items):
        for i in range(0, len(items), self.batch_size):
            chunk = items[i : i + self.batch_size]
            if not chunk:
                continue
            batch = {k: np.stack([it[k] for it in chunk]) for k in chunk[0]}
            if self.emit_frame_refs:
                batch.pop("mels")
                batch["item_idx"] = np.arange(i, i + len(chunk), dtype=np.int32)
            yield batch

    def train_batches(self):
        return self._batches(self.items)

    def val_batches(self):
        return self._batches(self.items[: self.batch_size])

    def test_batches(self):
        return self._batches(self.items[: self.batch_size])
