"""Batched serving: word ids -> mel -> wav on one card.

The counterpart of the JAX package's ``DictTTSTask.test_step`` plus
``DictTTSInferencer.synthesize_batch`` (``dicttts_tpu/infer.py``), from the
point where the text front end has produced word ids and sandhi overrides
(``infer.py::_prepare``). Two modes:

- device bank (production): the server holds the ``[V, L, E]`` dict bank
  and its ``[V, L]`` / ``[V, P]`` maps on the device; requests carry word
  ids only, and S2PA runs the gather-fused kernel K1 over the bank;
- gathered banks: each request carries its own ``[n, L, E]`` bank rows, as
  ``infer.py::_collate`` builds them; with ``use_pallas_s2pa`` S2PA runs the
  fused kernel K3.

One acoustic pass and one vocoder pass serve the whole batch. The vocoder
sees the batch cropped to the longest real length (bucketed to 64 frames)
with each row's tail at the mel silence floor.

    server = DictTTSServer(acoustic, vocoder, bank)       # device="cuda"
    results = server.synthesize_batch([Request(ids, pron)], seed=0)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from dicttts_tpu_torch.data.collate import shape_bucket
from dicttts_tpu_torch.models.dict_encoder import DictMsg
from dicttts_tpu_torch.models.dict_tts import DictTTS
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.ops.s2pa_bank import bank_tensor
from dicttts_tpu_torch.utils.device import resolve_device
from dicttts_tpu_torch.vocoders.hifigan import MEL_SILENCE, spec2wav

BANK_KEYS = ("keys", "key_map", "pinyin", "pinyin_map")


def vocoder_batch(mel_out: torch.Tensor, n_frames: torch.Tensor, n_max: int) -> torch.Tensor:
    """The vocoder's input for one batch: mel_out [B, T, 80] cropped to the
    longest real length (``n_max``, bucketed to 64 frames, at most T), each
    row's frames from its own ``n_frames[b]`` on at the mel silence floor,
    so that the padded tails cannot bleed into real audio through the
    generator's receptive field."""
    t_crop = min(shape_bucket(n_max, 64), mel_out.shape[1])
    frames = torch.arange(t_crop, device=mel_out.device)[None, :, None]
    return torch.where(frames < n_frames[:, None, None], mel_out[:, :t_crop], MEL_SILENCE)


def pinyin_decode(pron_attn: torch.Tensor, pinyin: torch.Tensor) -> torch.Tensor:
    """[B, Tw, P] pronunciation weights, [B, Tw, P] pinyin ids -> [B, Tw, 2]:
    the argmax pinyin slot and the next one, the winning sense's initial and
    final (each sense owns two slots)."""
    pron_idx = torch.argmax(pron_attn, dim=-1)  # [B, Tw]
    idx2 = torch.stack([pron_idx, torch.clamp(pron_idx + 1, max=pinyin.shape[2] - 1)], dim=-1)
    return torch.gather(pinyin, 2, idx2)


@dataclass
class Request:
    """One utterance: word ids with BOS/EOS ([n] ints, 0 = pad), sandhi
    sense overrides ([n], 0 = none) and, in gathered mode only, its bank
    rows {'keys' [n, L, E], 'key_map' [n, L], 'pinyin' [n, P],
    'pinyin_map' [n, P]} (numpy arrays or tensors)."""

    word_ids: np.ndarray
    pron_modified: np.ndarray | None = None
    bank: dict | None = None


@dataclass
class Result:
    wav: np.ndarray  # [n_frames * hop] float32
    mel: np.ndarray  # [n_frames, 80]
    n_frames: int
    pinyin_pred: np.ndarray  # [n_words, 2] pinyin ids (initial, final) per word


class DictTTSServer:
    def __init__(self, acoustic: DictTTS, vocoder: HifiGanGenerator, bank: dict | None = None,
                 max_frames: int = 1548, device="cuda"):
        self.device = resolve_device(device)
        self.acoustic = acoustic.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval()
        self.bank = None if bank is None else {k: bank_tensor(bank[k], self.device) for k in BANK_KEYS}
        self.max_frames = max_frames
        self.hop = math.prod(up.stride[0] for up in self.vocoder.ups)

    def _tensor(self, x) -> torch.Tensor:
        return bank_tensor(x, self.device)

    def collate(self, requests: list[Request]):
        """Pad requests to shared bucketed shapes -> (word_tokens [B, Tw],
        pron_modified [B, Tw], DictMsg), all on the device."""
        B = len(requests)
        lens = [len(r.word_ids) for r in requests]
        Tw = shape_bucket(max(lens), 8)
        wt = np.zeros((B, Tw), np.int32)
        pron = np.zeros((B, Tw), np.int32)
        for b, r in enumerate(requests):
            wt[b, :lens[b]] = r.word_ids
            if r.pron_modified is not None:
                pron[b, :lens[b]] = r.pron_modified
        gathered = [r.bank is not None for r in requests]
        if any(gathered) and not all(gathered):
            raise ValueError("a batch is either all device-bank or all gathered-bank requests")
        word_tokens, pron_modified = self._tensor(wt), self._tensor(pron)
        if not any(gathered):
            if self.bank is None:
                raise ValueError("requests carry no bank and the server holds none")
            V = self.bank["keys"].shape[0]
            if wt.min() < 0 or wt.max() >= V:
                raise ValueError(f"word ids must lie in [0, {V})")
            idx = word_tokens.long()
            keys = self.bank["keys"]
            dm = DictMsg(keys, keys, self.bank["key_map"][idx], self.bank["pinyin"][idx],
                         self.bank["pinyin_map"][idx])
            return word_tokens, pron_modified, dm
        banks = [{k: self._tensor(r.bank[k]) for k in BANK_KEYS} for r in requests]
        L = shape_bucket(max(bk["keys"].shape[1] for bk in banks), 8)
        P = shape_bucket(max(bk["pinyin"].shape[1] for bk in banks), 4)
        E = banks[0]["keys"].shape[-1]
        keys = torch.zeros((B, Tw, L, E), dtype=torch.float32, device=self.device)
        maps = {k: torch.zeros((B, Tw, L if k == "key_map" else P), dtype=torch.int32,
                               device=self.device) for k in BANK_KEYS[1:]}
        for b, bk in enumerate(banks):
            n = lens[b]
            keys[b, :n, :bk["keys"].shape[1]] = bk["keys"]
            for k, m in maps.items():
                m[b, :n, :bk[k].shape[1]] = bk[k]
        return word_tokens, pron_modified, DictMsg(keys, keys, maps["key_map"], maps["pinyin"],
                                                   maps["pinyin_map"])

    @torch.no_grad()
    def acoustic_batch(self, requests: list[Request], seed: int = 0,
                       noise: torch.Tensor | None = None) -> dict:
        """The acoustic pass of ``test_step``: mel_out [B, max_frames, 80],
        mel2word [B, max_frames], pron_attn [B, Tw, P] and pinyin_pred
        [B, Tw, 2] (``pinyin_decode``)."""
        word_tokens, pron_modified, dm = self.collate(requests)
        generator = None
        if noise is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        else:
            noise = noise.to(self.device)
        out = self.acoustic(word_tokens, dm, pron_modified, max_frames=self.max_frames,
                            noise=noise, generator=generator)
        return {
            "mel_out": out["mel_out"], "mel2word": out["mel2word"], "pron_attn": out["pron_attn"],
            "pinyin_pred": pinyin_decode(out["pron_attn"], dm.pinyin),
        }

    @torch.no_grad()
    def synthesize_batch(self, requests: list[Request], seed: int = 0,
                         noise: torch.Tensor | None = None) -> list[Result]:
        """Serve a batch: one acoustic pass, one vocoder pass; results in
        request order."""
        if not requests:
            return []
        out = self.acoustic_batch(requests, seed, noise)
        n_frames = (out["mel2word"] > 0).sum(dim=1)  # [B]
        n_host = n_frames.tolist()
        wav_b = spec2wav(self.vocoder, vocoder_batch(out["mel_out"], n_frames, max(n_host))).cpu().numpy()
        mel_host = out["mel_out"].cpu().numpy()
        pinyin_host = out["pinyin_pred"].cpu().numpy()
        return [
            Result(wav=wav_b[b, :n * self.hop], mel=mel_host[b, :n], n_frames=n,
                   pinyin_pred=pinyin_host[b, :len(r.word_ids)])
            for b, (r, n) in enumerate(zip(requests, n_host))
        ]
