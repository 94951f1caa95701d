"""Vocoder registry and API.

Port of ``dicttts_tpu/vocoders/base_vocoder.py``: vocoders register by
name; a config selects one with ``cfg['vocoder']`` (a registered name or a
dotted import path); every vocoder implements ``spec2wav`` (mel ->
waveform) and the static ``wav2spec`` (wav file or array -> (wav, mel)).
"""

from __future__ import annotations

import importlib

VOCODERS: dict[str, type] = {}


def register_vocoder(cls):
    VOCODERS[cls.__name__.lower()] = cls
    VOCODERS[cls.__name__] = cls
    return cls


def get_vocoder_cls(name: str):
    if name.lower() in VOCODERS:
        return VOCODERS[name.lower()]
    if "." in name:
        mod, cls = name.rsplit(".", 1)
        return getattr(importlib.import_module(mod), cls)
    raise KeyError(f"unknown vocoder {name!r}; registered: {sorted(VOCODERS)}")


class BaseVocoder:
    def spec2wav(self, mel):
        """mel [T, 80] (or [B, T, 80]) -> waveform [T*hop] (or batched)."""
        raise NotImplementedError

    @staticmethod
    def wav2spec(wav_fn, cfg):
        """wav path or float array -> (wav, mel [T, 80])."""
        raise NotImplementedError
