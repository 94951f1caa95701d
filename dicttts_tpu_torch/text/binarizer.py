"""Offline binarization: a raw corpus -> IndexedDataset binaries.

Port of ``dicttts_tpu/text/binarizer.py``. Two stages:

- pre-align (``PreAlign`` and the corpus adapters ``BiaobeiPreAlign`` and
  ``WenetSpeechPreAlign``): read the adapter's (item_name, wav_fn, text[,
  speaker]), optionally trim, denoise and resample each wav on the host,
  run the zh_dict g2p, and write metadata_phone.csv, phone_set.json and
  word_set.json;
- binarize (``ZhBinarizer``): split the rows into disjoint test, valid and
  train sets; for each chunk of ``binarize_batch`` wavs, one batched pass
  on the binarizer's device gives every item's log10 mel
  (``ops/mel.batched_log10_mel``) and f0 (``ops/f0.batched_f0``); the text
  work (word structures, the alignment from an MFA TextGrid or a uniform
  one, the sandhi overrides) runs on the host, fanned out to
  ``binarize_workers`` spawned processes while the device computes; write
  ``{train,valid,test}.{data,idx}``, the lengths and f0 statistics, and the
  dictionary bank ``dict_embed.{data,idx}`` with ``pinyin_encoder.pkl``.
  With ``with_spk_embed`` each item also gets ``spk_embed``
  (``ops/speaker.speaker_embed``: the GE2E encoder on the binarizer's
  device when ``spk_encoder_ckpt`` names a Resemblyzer checkpoint, else
  the spectral statistics).

The bank's gloss features come from a RoFormer LM when ``lm_model`` names
a local directory (mean of the input embedding and the first 8 hidden
layers), else from the deterministic stand-in: one gaussian row per gloss
character, seeded by the character's crc32, the same bytes as the JAX
package's. Items and banks are written with the JAX package's dtypes.

Tone sandhi needs jieba; ``sandhi_overrides`` names a JSON file
{text: overrides} to use on a machine without it (``text/sandhi.FixedSandhi``).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import pickle
import re
import time
import zlib
from collections import Counter

import numpy as np
import torch

from dicttts_tpu_torch.data.collate import shape_bucket
from dicttts_tpu_torch.ops.f0 import batched_f0
from dicttts_tpu_torch.ops.mel import batched_log10_mel
from dicttts_tpu_torch.text.pinyin import ZhG2P, load_dict, pinyin_to_tone3
from dicttts_tpu_torch.text.sandhi import FixedSandhi, SandhiProcessor
from dicttts_tpu_torch.text.textgrid import parse_textgrid, textgrid_to_mel2ph
from dicttts_tpu_torch.utils.device import resolve_device
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder
from dicttts_tpu_torch.utils.text_encoder import TokenTextEncoder
from dicttts_tpu_torch.vocoders.hifigan import load_wav, save_wav

log = logging.getLogger("dicttts_tpu_torch.binarizer")

DEFAULT_DICT = "data/zh-dict.json"


def _word_structures(g2p, text: str, ph_list: list[str]):
    """words (with <BOS>/<EOS>), the phones with them, and ph2word: each
    character takes its 1-2 phones, a separator the previous character."""
    words = ["<BOS>"] + list(text) + ["<EOS>"]
    ph2word = []
    full_ph = ["<BOS>"] + ph_list + ["<EOS>"]
    word_idx = 1
    char_cursor = 0
    for ph in full_ph:
        if ph == "<BOS>":
            ph2word.append(1)
        elif ph == "<EOS>":
            ph2word.append(len(words))
        elif ph in ("#", "|"):
            ph2word.append(word_idx)
        else:
            if char_cursor == 0:
                word_idx += 1
            char = text[word_idx - 2] if word_idx - 2 < len(text) else ""
            n_ph = len(g2p.char_phones(char)) if char else 1
            char_cursor += 1
            ph2word.append(word_idx)
            if char_cursor >= n_ph:
                char_cursor = 0
    return words, full_ph, ph2word


def _align_structures(full_ph, ph2word, tg_text, T, hop, sr):
    """mel2ph (from the TextGrid when given, else uniform over the real
    phones) and mel2word."""
    if tg_text:
        mel2ph, _ = textgrid_to_mel2ph(parse_textgrid(tg_text), full_ph, T, hop, sr)
    else:
        real = [i for i, p in enumerate(full_ph) if p not in ("#", "|")]
        per = max(T // max(len(real), 1), 1)
        mel2ph = []
        for j, i in enumerate(real):
            n = per if j < len(real) - 1 else T - per * (len(real) - 1)
            mel2ph.extend([i + 1] * max(n, 0))
        mel2ph = (mel2ph + [real[-1] + 1] * T)[:T]
    mel2word = [ph2word[m - 1] if m > 0 else 0 for m in mel2ph]
    return mel2ph, mel2word


def make_sandhi(zh_dict, overrides_path: str | None):
    """The sandhi engine (jieba), or the precomputed overrides in
    ``overrides_path`` (JSON {text: overrides})."""
    if overrides_path:
        with open(overrides_path, encoding="utf-8") as f:
            return FixedSandhi(json.load(f))
    return SandhiProcessor(zh_dict)


# per worker process: the dictionary, g2p and sandhi engine, built once
_HOST_CTX: dict = {}


def host_item_structures(item_name, text, ph_list, tg_text, T, hop, sr, dict_path, pos_merge,
                         sandhi_overrides=None):
    """All of an item's host-side text work: word structures, alignment,
    sandhi. A function of small inputs (no arrays), run in the worker
    processes; raises on a broken item, which the caller skips."""
    key = (dict_path, pos_merge, sandhi_overrides)
    ctx = _HOST_CTX.get(key)
    if ctx is None:
        ctx = (ZhG2P(dict_path, pos_merge=pos_merge), make_sandhi(load_dict(dict_path), sandhi_overrides))
        _HOST_CTX[key] = ctx
    g2p, sandhi = ctx
    words, full_ph, ph2word = _word_structures(g2p, text, ph_list)
    mel2ph, mel2word = _align_structures(full_ph, ph2word, tg_text, T, hop, sr)
    pron_modified = [0] + sandhi.process_sandhi(text, None) + [0]
    return {"item_name": item_name, "words": words, "full_ph": full_ph, "ph2word": ph2word,
            "mel2ph": mel2ph, "mel2word": mel2word, "pron_modified": pron_modified}


def _g2p(cfg: dict) -> ZhG2P:
    return ZhG2P(cfg.get("dict_path", DEFAULT_DICT),
                 pos_merge=cfg.get("txt_processor", "zh_dict") == "zh_dict",
                 strict_nsw=bool(cfg.get("nsw_strict_reference", False)))


class PreAlign:
    """Stage 1: text processing and the metadata (upstream base_pre_align.py)."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.g2p = _g2p(cfg)

    def meta_data(self):
        """Yield (item_name, wav_fn, text[, spk]). Corpus adapters override."""
        raise NotImplementedError

    def process_wav(self, item_name: str, wav_fn: str) -> str:
        """``pre_align_args``' trim_sil, denoise and resample on the host:
        write the processed copy to processed_data_dir/wav_inputs/ and
        return its path (``wav_fn`` itself when none is set)."""
        args = self.cfg.get("pre_align_args", {})
        if not (args.get("trim_sil") or args.get("denoise") or args.get("resample")):
            return wav_fn
        wav, sr = load_wav(wav_fn)
        target_sr = self.cfg.get("audio_sample_rate", 22050)
        if args.get("resample") and sr != target_sr:
            # FFT resample: keep the bins below the new Nyquist
            n_out = int(round(len(wav) * target_sr / sr))
            spec = np.fft.rfft(wav)
            n_keep = min(len(spec), n_out // 2 + 1)
            out_spec = np.zeros(n_out // 2 + 1, complex)
            out_spec[:n_keep] = spec[:n_keep]
            wav = np.fft.irfft(out_spec, n_out).astype(np.float32) * (n_out / len(wav))
            sr = target_sr
        if args.get("denoise"):
            from dicttts_tpu_torch.vocoders.denoise import denoise

            wav = denoise(wav)
        if args.get("trim_sil"):
            # librosa.effects.trim: drop leading and trailing frames more
            # than top_db below the loudest frame's rms
            top_db = float(args.get("trim_top_db", 60))
            frame, hop = 2048, 512
            n = max(1 + (len(wav) - frame) // hop, 1)
            rms = np.asarray([np.sqrt(np.mean(np.square(wav[i * hop:i * hop + frame])))
                              for i in range(n)])
            keep = np.where(rms > rms.max() * 10 ** (-top_db / 20))[0]
            if len(keep):
                wav = wav[keep[0] * hop:min(keep[-1] * hop + frame, len(wav))]
        out_dir = os.path.join(self.cfg["processed_data_dir"], "wav_inputs")
        os.makedirs(out_dir, exist_ok=True)
        new_fn = os.path.join(out_dir, f"{item_name}.wav")
        save_wav(new_fn, wav, sr)
        return new_fn

    def process(self):
        out_dir = self.cfg["processed_data_dir"]
        os.makedirs(out_dir, exist_ok=True)
        rows, phones, words = [], Counter(), Counter()
        for item in self.meta_data():
            item_name, wav_fn, text = item[:3]
            wav_fn = self.process_wav(item_name, wav_fn)
            spk = item[3] if len(item) > 3 else "<SINGLE_SPK>"
            ph_list, norm_text = self.g2p.process(text)
            rows.append([item_name, wav_fn, norm_text, " ".join(ph_list), spk])
            phones.update(ph_list)
            words.update(["<BOS>", "<EOS>"] + list(norm_text))
        with open(os.path.join(out_dir, "metadata_phone.csv"), "w", newline="") as f:
            csv.writer(f).writerows(rows)
        with open(os.path.join(out_dir, "phone_set.json"), "w") as f:
            json.dump(sorted(phones), f, ensure_ascii=False)
        with open(os.path.join(out_dir, "word_set.json"), "w") as f:
            json.dump([w for w, _ in words.most_common(self.cfg.get("word_size", 8000))], f,
                      ensure_ascii=False)
        log.info("pre-align: %d items, %d phones, %d words", len(rows), len(phones), len(words))
        return rows


class BiaobeiPreAlign(PreAlign):
    """BZNSYP (Biaobei): ProsodyLabeling/000001-010000.txt, the #N prosody
    marks stripped."""

    def meta_data(self):
        raw = self.cfg["raw_data_dir"]
        with open(os.path.join(raw, "ProsodyLabeling", "000001-010000.txt"), encoding="utf-8") as f:
            lines = f.readlines()
        for i in range(0, len(lines), 2):
            item_name, text = lines[i].strip().split("\t")
            yield item_name, os.path.join(raw, "Wave", f"{item_name}.wav"), re.sub(r"#\d", "", text)


class WenetSpeechPreAlign(PreAlign):
    """The WenetSpeech podcast subset: extracted_wav/wenetspeech.txt, lines
    of wav_path<TAB>text, podcast lines only. With ``use_spk_id`` the
    podcast directory is the speaker, else every item is 'asr_data'."""

    def meta_data(self):
        raw = self.cfg["raw_data_dir"]
        with open(os.path.join(raw, "extracted_wav", "wenetspeech.txt"), encoding="utf-8") as f:
            lines = f.readlines()
        for line in lines:
            line = line.strip()
            if not line or "podcast" not in line:
                continue
            wav_fn, text = line.split("\t")[:2]
            base = "_".join(wav_fn.split("/")[-2:])
            spk = wav_fn.split("/")[-2] if self.cfg.get("use_spk_id") else "asr_data"
            yield f"asr_data_{base}", wav_fn, text, spk


class ZhBinarizer:
    """Stage 2. ``device``: where the mel and f0 run (the card by default;
    it raises without one; "cpu" for tests). ``stats`` holds what
    ``process`` measured: items, seconds in the feature passes and in the
    bank, the bank's bytes, the split sizes."""

    def __init__(self, cfg: dict, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.zh_dict = load_dict(cfg.get("dict_path", DEFAULT_DICT))
        self.sandhi = make_sandhi(self.zh_dict, cfg.get("sandhi_overrides"))
        self.g2p = _g2p(cfg)
        self.stats: dict = {}

    def _mel_kw(self, sr: int) -> dict:
        cfg = self.cfg
        return dict(sample_rate=sr, n_fft=cfg.get("fft_size", 1024), hop=cfg.get("hop_size", 256),
                    win_length=cfg.get("win_size", 1024), n_mels=cfg.get("audio_num_mel_bins", 80),
                    fmin=cfg.get("fmin", 80.0), fmax=cfg.get("fmax", 7600.0))

    # -- features ---------------------------------------------------------------
    def _batched_features(self, wavs: list[np.ndarray], sr: int):
        """One pass for a chunk: the wavs zero-padded to a bucketed length
        (a multiple of hop * 128), mel and f0 of the stack on the device,
        each item's leading 1 + len // hop frames (the right pad cannot
        change them: the STFT's center pad is zeros too)."""
        hop = self.cfg.get("hop_size", 256)
        t_max = shape_bucket(max(len(w) for w in wavs), multiple=hop * 128)
        stack = np.zeros((len(wavs), t_max), np.float32)
        for i, w in enumerate(wavs):
            stack[i, :len(w)] = w[:t_max]
        x = torch.as_tensor(stack).to(self.device)
        mels = batched_log10_mel(x, **self._mel_kw(sr))
        f0s = batched_f0(x, sample_rate=sr, hop=hop, n_frames=mels.shape[1])
        mels, f0s = mels.cpu().numpy(), f0s.cpu().numpy()
        return [(mels[i, :1 + min(len(w), t_max) // hop], f0s[i, :1 + min(len(w), t_max) // hop])
                for i, w in enumerate(wavs)]

    # -- items ------------------------------------------------------------------
    def process_item(self, item_name: str, text: str, ph_list: list[str], tg_path: str | None,
                     ph_encoder, word_encoder, features, spk_id: int = 0, structures=None) -> dict:
        """One item. ``features``: (wav, sr, mel, f0) from the batched pass;
        ``structures``: ``host_item_structures``' result, else computed here."""
        wav, sr, mel, f0 = features
        T = mel.shape[0]
        if structures is None:
            words, full_ph, ph2word = _word_structures(self.g2p, text, ph_list)
            tg_text = None
            if tg_path and os.path.exists(tg_path):
                with open(tg_path, encoding="utf-8") as f:
                    tg_text = f.read()
            mel2ph, mel2word = _align_structures(full_ph, ph2word, tg_text, T,
                                                 self.cfg.get("hop_size", 256), sr)
            pron_modified = [0] + self.sandhi.process_sandhi(text, None) + [0]
        else:
            words, full_ph, ph2word = structures["words"], structures["full_ph"], structures["ph2word"]
            mel2ph, mel2word = structures["mel2ph"], structures["mel2word"]
            pron_modified = structures["pron_modified"]
        item = {
            "item_name": item_name,
            "txt": text,
            "phone": ph_encoder.encode(" ".join(full_ph)),
            "ph": " ".join(full_ph),
            "mel": mel.astype(np.float32),
            "wav": wav.astype(np.float32) if self.cfg.get("with_wav") else None,
            "f0": f0.astype(np.float32),
            "mel2ph": np.asarray(mel2ph, np.int64),
            "words": words,
            "word_tokens": word_encoder.encode(" ".join(words)),
            "ph2word": np.asarray(ph2word, np.int64),
            "mel2word": np.asarray(mel2word, np.int64),
            "pron_modified": np.asarray(pron_modified, np.int64),
            "spk_id": int(spk_id),
            "len": T,
            "sec": len(wav) / sr,
        }
        if self.cfg.get("with_spk_embed"):
            from dicttts_tpu_torch.ops.speaker import speaker_embed

            item["spk_embed"] = speaker_embed(mel, f0, self.cfg, wav=wav, sr=sr, device=self.device)
        if self.cfg.get("with_f0cwt"):
            from dicttts_tpu_torch.ops.cwt import f0_cwt

            cwt = f0_cwt(item["f0"])
            item["cwt_spec"], item["cwt_mean"], item["cwt_std"] = (
                cwt["cwt_spec"], cwt["cwt_mean"], cwt["cwt_std"])
        return item

    # -- dictionary bank --------------------------------------------------------
    def _gloss_encoder(self):
        """fn(gloss text) -> ([L, dict_embed_dim] features, tokens): RoFormer
        when ``lm_model`` is a local directory, else the crc32 stand-in."""
        lm = self.cfg.get("lm_model", "")
        if lm and os.path.exists(lm):
            from transformers import AutoModel, AutoTokenizer

            tok = AutoTokenizer.from_pretrained(lm)
            model = AutoModel.from_pretrained(lm, output_hidden_states=True).eval()

            def encode(text: str):
                with torch.no_grad():
                    ids = tok(text, return_tensors="pt", truncation=True, max_length=64)
                    hs = model(**ids).hidden_states  # (embedding, layer 1, ...)
                    # mean of the input embedding and the first 8 layers
                    # (upstream binarizer_zh.py:213-233), by the actual count
                    sel = hs[:9]
                    feats = sum(sel) / float(len(sel))
                    return (feats[0].numpy().astype(np.float32),
                            tok.convert_ids_to_tokens(ids["input_ids"][0]))

            return encode

        dim = self.cfg.get("dict_embed_dim", 768)
        rows: dict[str, np.ndarray] = {}  # each character's row, drawn once: seeding dominates

        def row(t: str) -> np.ndarray:
            if t not in rows:
                # a stable content hash (not hash(), which is salted per process)
                rows[t] = np.random.RandomState(zlib.crc32(t.encode("utf-8")) & 0x7FFFFFFF).randn(
                    dim).astype(np.float32)
            return rows[t]

        def encode(text: str):
            toks = list(text)[:64]
            feats = np.stack([row(t) for t in toks]) if toks else np.zeros((1, dim), np.float32)
            return feats, toks

        return encode

    def gen_dict_embeddings(self, word_encoder: TokenTextEncoder, out_dir: str):
        """dict_embed: per word id, the gloss features of every reading
        concatenated, with the sense id of each row (0 for [CLS]/[SEP]),
        exactly 2 pinyin tokens per reading (the initial, '' included, and
        the final) and their sense ids; pinyin_encoder.pkl. A word absent
        from the dictionary gets 3 zero rows with key_map [0, 1, 0] and the
        pinyin ['<UNK>']. Returns the pinyin vocabulary."""
        encode = self._gloss_encoder()
        pinyin_vocab: list[str] = ["<pad>", "<UNK>"]
        builder = IndexedDatasetBuilder(os.path.join(out_dir, "dict_embed"))
        dim = self.cfg.get("dict_embed_dim", 768)
        max_senses = int(self.cfg.get("s2pa_max_senses", 10))
        special_gloss_toks = {"[CLS]", "[SEP]"}
        for idx in range(word_encoder.vocab_size):
            word = word_encoder.id_to_token.get(idx, "")
            prons = self.zh_dict.prons(word)
            keys, key_map, pinyin_toks, pinyin_map, glosses = [], [], [], [], []
            for sense_id, pron in enumerate(prons, start=1):
                gloss_text = "".join(self.zh_dict.glosses(word, pron))[:48] or word
                feats, toks = encode(gloss_text)
                keys.append(feats)
                key_map.extend(0 if t in special_gloss_toks else sense_id
                               for t in (toks + [""] * (len(feats) - len(toks))))
                glosses.append(toks)
                for p in pinyin_to_tone3(pron):  # always both, an empty initial included
                    if p not in pinyin_vocab:
                        pinyin_vocab.append(p)
                    pinyin_toks.append(p)
                    pinyin_map.append(sense_id)
            if not keys:
                keys = [np.zeros((3, dim), np.float32)]
                key_map = [0, 1, 0]
                pinyin_toks, pinyin_map, glosses = ["<UNK>"], [1], [["O"]]
            # the grouped sense modes have a fixed s2pa_max_senses axis: more
            # readings than that would drop attention mass in training
            if len(prons) > max_senses:
                raise ValueError(f"word {word!r} has {len(prons)} pronunciations > "
                                 f"s2pa_max_senses={max_senses}; raise s2pa_max_senses in the config")
            key_arr = np.concatenate(keys, axis=0)
            builder.add_item({"key": key_arr, "value": key_arr,
                              "key_map": np.asarray(key_map, np.int64), "pinyin": pinyin_toks,
                              "pinyin_map": np.asarray(pinyin_map, np.int64), "tokens_gloss": glosses})
        builder.finalize()
        with open(os.path.join(out_dir, "pinyin_encoder.pkl"), "wb") as f:
            pickle.dump(pinyin_vocab, f)
        log.info("dict bank: %d entries, pinyin vocab %d", word_encoder.vocab_size, len(pinyin_vocab))
        return pinyin_vocab

    # -- main -------------------------------------------------------------------
    def _n_workers(self, total_items: int) -> int:
        """``binarize_workers``; 'auto': up to 8 below the core count when
        there are at least 64 items (a spawned worker takes seconds to start)."""
        requested = self.cfg.get("binarize_workers", "auto")
        if requested in ("auto", None, ""):
            return min(max((os.cpu_count() or 2) - 1, 1), 8) if total_items >= 64 else 1
        return int(requested)

    def process(self):
        cfg = self.cfg
        proc_dir, out_dir = cfg["processed_data_dir"], cfg["binary_data_dir"]
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(proc_dir, "phone_set.json")) as f:
            phone_set = sorted(set(json.load(f)) | {"<BOS>", "<EOS>", "#", "|"})
        with open(os.path.join(proc_dir, "word_set.json")) as f:
            word_set = json.load(f)
        ph_encoder = TokenTextEncoder(phone_set, replace_oov="<UNK>")
        word_encoder = TokenTextEncoder(word_set, replace_oov="<UNK>")
        for name, values in (("phone_set.json", phone_set), ("word_set.json", word_set)):
            with open(os.path.join(out_dir, name), "w") as f:
                json.dump(values, f, ensure_ascii=False)
        with open(os.path.join(proc_dir, "metadata_phone.csv")) as f:
            rows = list(csv.reader(f))
        # the speaker map from the adapters' labels (upstream build_spk_map)
        spks = sorted({row[4] if len(row) > 4 and row[4] else "<SINGLE_SPK>" for row in rows}) or [
            "<SINGLE_SPK>"]
        spk_map = {s: i for i, s in enumerate(spks)}
        if len(spk_map) > cfg.get("num_spk", 1) and cfg.get("use_spk_id"):
            raise ValueError(f"{len(spk_map)} speakers but num_spk={cfg.get('num_spk', 1)}")
        with open(os.path.join(out_dir, "spk_map.json"), "w") as f:
            json.dump(spk_map, f, ensure_ascii=False)
        if cfg.get("binarization_shuffle", False):
            import random

            random.Random(1234).shuffle(rows)
        test_num = cfg.get("test_num", min(200, max(1, len(rows) // 10)))
        valid_num = cfg.get("valid_num", test_num)
        # disjoint splits (upstream aliases test = valid = the first test_num)
        splits = {"test": rows[:test_num], "valid": rows[test_num:test_num + valid_num],
                  "train": rows[test_num + valid_num:]}
        tg_dir = os.path.join(proc_dir, "mfa_outputs")
        chunk_size = max(int(cfg.get("binarize_batch", 16)), 1)
        sr_cfg = cfg.get("audio_sample_rate", 22050)
        hop = cfg.get("hop_size", 256)
        n_workers = self._n_workers(sum(len(r) for r in splits.values()))
        dict_path = cfg.get("dict_path", DEFAULT_DICT)
        pos_merge = cfg.get("txt_processor", "zh_dict") == "zh_dict"
        pool = None
        if n_workers > 1:
            from dicttts_tpu_torch.utils.multiprocess import MultiprocessManager

            pool = MultiprocessManager(n_workers)
        stats = {"items": 0, "chunks": 0, "features_s": 0.0, "workers": n_workers, "splits": {}}
        t_start = time.perf_counter()
        try:
            for split, split_rows in splits.items():
                builder = IndexedDatasetBuilder(os.path.join(out_dir, split))
                lengths, f0_all = [], []
                for start in range(0, len(split_rows), chunk_size):
                    loaded = []  # (row, wav, sr)
                    for row in split_rows[start:start + chunk_size]:
                        try:
                            wav, sr = (load_wav(row[1]) if isinstance(row[1], str)
                                       else (np.asarray(row[1], np.float32), sr_cfg))
                            loaded.append((row, wav, sr))
                        except Exception as e:
                            log.warning("skip %s (wav load): %s", row[0], e)
                    if not loaded:
                        continue
                    if pool is not None:  # text jobs first: they run while the device computes
                        for row, wav, sr in loaded:
                            tg = os.path.join(tg_dir, f"{row[0]}.TextGrid")
                            tg_text = None
                            if os.path.exists(tg):
                                with open(tg, encoding="utf-8") as f:
                                    tg_text = f.read()
                            pool.add_job(host_item_structures, (
                                row[0], row[2], row[3].split(), tg_text, 1 + len(wav) // hop, hop, sr,
                                dict_path, pos_merge, cfg.get("sandhi_overrides")))
                    t = time.perf_counter()
                    feats = self._batched_features([w for _, w, _ in loaded], loaded[0][2])
                    stats["features_s"] += time.perf_counter() - t
                    stats["chunks"] += 1
                    structs = list(pool.get_results()) if pool is not None else [None] * len(loaded)
                    for (row, wav, sr), (mel, f0), structures in zip(loaded, feats, structs):
                        item_name, text, ph_str = row[0], row[2], row[3]
                        spk = row[4] if len(row) > 4 and row[4] else "<SINGLE_SPK>"
                        if pool is not None and structures is None:
                            log.warning("skip %s: host-structure worker failed", item_name)
                            continue
                        tg = os.path.join(tg_dir, f"{item_name}.TextGrid")
                        try:
                            item = self.process_item(
                                item_name, text, ph_str.split(), tg if os.path.exists(tg) else None,
                                ph_encoder, word_encoder, (wav, sr, mel, f0), spk_id=spk_map.get(spk, 0),
                                structures=structures)
                        except Exception as e:  # a broken item is skipped, the run goes on
                            log.warning("skip %s: %s", item_name, e)
                            continue
                        builder.add_item(item)
                        lengths.append(item["len"])
                        f0_all.append(item["f0"][item["f0"] > 0])
                builder.finalize()
                if split_rows and not lengths:
                    raise RuntimeError(f"binarize {split}: all {len(split_rows)} items failed (see the "
                                       "warnings above); an empty split is not written")
                np.save(os.path.join(out_dir, f"{split}_lengths.npy"), np.asarray(lengths))
                if f0_all:
                    f0_cat = np.concatenate(f0_all) if any(len(x) for x in f0_all) else np.zeros(1)
                    np.save(os.path.join(out_dir, f"{split}_f0s_mean_std.npy"),
                            np.asarray([f0_cat.mean(), f0_cat.std()]))
                stats["splits"][split] = len(lengths)
                stats["items"] += len(lengths)
                log.info("binarized %s: %d items", split, len(lengths))
        finally:
            if pool is not None:
                pool.close()
        stats["items_s"] = time.perf_counter() - t_start
        if cfg.get("use_dict", True):
            t = time.perf_counter()
            self.gen_dict_embeddings(word_encoder, out_dir)
            stats["bank_s"] = time.perf_counter() - t
            stats["bank_bytes"] = os.path.getsize(os.path.join(out_dir, "dict_embed.data"))
        self.stats = stats
        return stats
