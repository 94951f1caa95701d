"""One-shot synthesis: Chinese text -> waveform.

Port of ``dicttts_tpu/infer.py`` (``DictTTSInferencer``): normalizes the
text, encodes its characters as word ids, takes the sandhi overrides,
builds the per-utterance dictionary bank from the binarized
``dict_embed``, runs DictTTS (predicted durations, sampled prior) through
``DictTTSTask.test_step`` on gathered banks, vocodes with the registered
vocoder, and returns (and writes) the wav with the predicted pinyin per
character (for PER scoring). With ``use_pallas_s2pa`` S2PA runs the fused
kernel K3 once per batch; the recipe leaves it off (eager S2PA).

    from dicttts_tpu_torch.infer import DictTTSInferencer
    inf = DictTTSInferencer(cfg)            # the card; newest ckpt + vocoder
    wav, info = inf.synthesize("今天天气真好")

The card is the default device; without one the constructor raises
unless ``device="cpu"`` is given. Tone sandhi needs jieba; where it is not
installed, pass ``sandhi=text.sandhi.FixedSandhi(overrides)`` with the overrides that
``SandhiProcessor.process_sandhi`` gave for each normalized text.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from dicttts_tpu_torch.data.collate import shape_bucket
from dicttts_tpu_torch.data.datasets import utterance_bank
from dicttts_tpu_torch.eval.metrics import Timer
from dicttts_tpu_torch.eval.per import decode_pinyin_ids, merge_token_pairs
from dicttts_tpu_torch.serve import vocoder_batch
from dicttts_tpu_torch.text.pinyin import ZhG2P, load_dict
from dicttts_tpu_torch.text.sandhi import SandhiProcessor
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint
from dicttts_tpu_torch.utils.device import resolve_device
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset
from dicttts_tpu_torch.utils.text_encoder import TokenTextEncoder
from dicttts_tpu_torch.vocoders import get_vocoder_cls
from dicttts_tpu_torch.vocoders.hifigan import save_wav


class DictTTSInferencer:
    """cfg: the recipe's config (``binary_data_dir`` with word_set.json,
    pinyin_encoder.pkl and dict_embed; ``dict_path``; ``work_dir``, whose
    newest checkpoint is restored; the vocoder's keys); state: the
    generator's parameters given directly, as ``task.state_dict()`` holds
    them ({'params_g': ...}); sandhi: an object with ``process_sandhi``
    in place of the jieba-based ``SandhiProcessor``."""

    def __init__(self, cfg: dict, state: dict | None = None, device="cuda", sandhi=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        data_dir = cfg["binary_data_dir"]
        with open(os.path.join(data_dir, "word_set.json")) as f:
            self.word_encoder = TokenTextEncoder(json.load(f), replace_oov="<UNK>")
        with open(os.path.join(data_dir, "pinyin_encoder.pkl"), "rb") as f:
            self.pinyin_list = pickle.load(f)
        self.dict_ds = IndexedDataset(os.path.join(data_dir, "dict_embed"))
        dict_path = cfg.get("dict_path", "data/zh-dict.json")
        self.g2p = ZhG2P(dict_path, pos_merge=cfg.get("txt_processor", "zh_dict") == "zh_dict",
                         strict_nsw=bool(cfg.get("nsw_strict_reference", False)))
        self.sandhi = sandhi if sandhi is not None else SandhiProcessor(load_dict(dict_path))
        self.task = DictTTSTask(cfg, device=self.device)  # neither data nor bank: gathered banks
        self.task.build_state(0)
        if state is None and cfg.get("work_dir"):
            last = get_last_checkpoint(cfg["work_dir"])
            if last:
                state = load_checkpoint(last, map_location=self.device)[1]
        if state is not None:
            self.task.model.load_state_dict(state["params_g"])
        self.vocoder = get_vocoder_cls(cfg.get("vocoder", "HifiGanVocoder"))(cfg, device=self.device)

    def _bank_for(self, chars: list[str]) -> dict:
        """Per-char dict bank for the real chars only, with BOS/EOS rows, by
        the training collater's rule (``utterance_bank``), so that the
        inference input distribution matches training; int64 maps and the
        values aliasing the keys, as the JAX inferencer builds them."""
        out, _ = utterance_bank(self.dict_ds, self.word_encoder.token_to_id, self.pinyin_list, chars,
                                read_values=False, int_dtype=np.int64)
        out["values"] = out["keys"]
        return out

    def _prepare(self, text: str) -> dict:
        """Text -> per-utterance features (unpadded)."""
        norm = self.g2p.preprocess(text)
        chars = list(norm)
        ids = self.word_encoder.encode(" ".join(["<BOS>"] + chars + ["<EOS>"]))
        pron = np.asarray([0] + self.sandhi.process_sandhi(norm, None) + [0], np.int32)
        return {"norm": norm, "chars": chars, "ids": ids, "pron": pron, "bank": self._bank_for(chars)}

    def _collate(self, feats: list[dict]) -> dict:
        """Pad prepared utterances to shared bucket shapes: the word axis to
        8, the gloss axis to 8 and the pinyin axis to 4."""
        B = len(feats)
        Tw = shape_bucket(max(len(f["ids"]) for f in feats), 8)
        L = shape_bucket(max(f["bank"]["keys"].shape[1] for f in feats), 8)
        P = shape_bucket(max(f["bank"]["pinyin"].shape[1] for f in feats), 4)
        E = feats[0]["bank"]["keys"].shape[-1]
        batch = {
            "word_tokens": np.zeros((B, Tw), np.int32),
            "pron_modified": np.zeros((B, Tw), np.int32),
            "keys": np.zeros((B, Tw, L, E), np.float32),
            "key_map": np.zeros((B, Tw, L), np.int32),
            "pinyin": np.zeros((B, Tw, P), np.int32),
            "pinyin_map": np.zeros((B, Tw, P), np.int32),
        }
        for b, f in enumerate(feats):
            n = len(f["ids"])
            batch["word_tokens"][b, :n] = f["ids"]
            batch["pron_modified"][b, :n] = f["pron"]
            for k in ("keys", "key_map", "pinyin", "pinyin_map"):
                batch[k][b, :n, : f["bank"][k].shape[1]] = f["bank"][k]
        batch["values"] = batch["keys"]
        return batch

    def _decode_pinyin(self, pinyin_pred_row: np.ndarray, n_chars: int) -> list[str]:
        """argmax 2-token windows -> syllables (the reference decode format)."""
        toks = decode_pinyin_ids(pinyin_pred_row, n_chars, self.pinyin_list)
        return merge_token_pairs([t for t in toks if t != "<UNK>"])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def synthesize_batch(self, texts: list[str], seed: int = 0, out_wavs: list[str] | None = None,
                         noise: torch.Tensor | None = None) -> list[tuple]:
        """Batched serving: one acoustic pass and one vocoder pass for the
        whole batch. ``noise`` [B, max_frames / 4, latent] replaces the
        prior's draw from ``seed``. Returns [(wav, info), ...] in input order.
        With ``profile_infer`` the stages (front_end, acoustic, vocoder) add
        their seconds to ``Timer.totals``; each closes after its
        device-to-host copy."""
        if not texts:
            return []
        profile = self.cfg.get("profile_infer", False)
        with Timer("front_end", enable=profile):
            feats = [self._prepare(t) for t in texts]
            batch = self._collate(feats)
        with Timer("acoustic", enable=profile, sync_fn=self._sync):
            dev = self.task.to_device({k: v for k, v in batch.items() if k != "values"})
            dev["values"] = dev["keys"]  # one upload: values are the keys
            generator = None if noise is not None else torch.Generator(self.device).manual_seed(seed)
            out = self.task.test_step(dev, generator,
                                      noise=None if noise is None else noise.to(self.device))
            n_frames = (out["mel2word"] > 0).sum(dim=1)
            n_host = n_frames.tolist()
            mel_host = out["mel_out"].cpu().numpy()
            pinyin_host = out["pinyin_pred"].cpu().numpy()
        with Timer("vocoder", enable=profile, sync_fn=self._sync):
            wav_b = self.vocoder.spec2wav(vocoder_batch(out["mel_out"], n_frames, max(n_host)))
        if profile:
            print("| profile_infer totals:", {k: round(v, 4) for k, v in Timer.totals.items()})
        sr = self.cfg.get("audio_sample_rate", 22050)
        results = []
        for b, f in enumerate(feats):
            n = n_host[b]
            wav = wav_b[b, : n * self.vocoder.hop]
            info = {"mel": mel_host[b, :n], "pinyin": self._decode_pinyin(pinyin_host[b], len(f["chars"])),
                    "text": f["norm"], "n_frames": n}
            if out_wavs and out_wavs[b]:
                save_wav(out_wavs[b], wav, sr)
            results.append((wav, info))
        return results

    def synthesize(self, text: str, seed: int = 0, out_wav: str | None = None):
        """One utterance: (wav, info), as ``synthesize_batch`` gives them."""
        return self.synthesize_batch([text], seed=seed, out_wavs=[out_wav])[0]
