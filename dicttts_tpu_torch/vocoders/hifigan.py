"""HiFi-GAN inference: ``spec2wav``, the vocoder's checkpoint and ``save_wav``,
as in ``dicttts_tpu/vocoders/hifigan.py``.

The mel length is padded up to a multiple of 64 frames with the log10-mel
silence floor (-6.0, not 0.0, which would be loud energy bleeding into the
tail through the generator's receptive field), vocoded, and cropped back
to ``T * hop`` samples.
"""

from __future__ import annotations

import math
import wave

import numpy as np
import torch

from dicttts_tpu_torch.data.collate import shape_bucket
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

MEL_SILENCE = -6.0  # log10(1e-6), the mel floor


@torch.no_grad()
def spec2wav(generator: HifiGanGenerator, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, 80] (or [T, 80]) -> wav [B, T * hop] (or [T * hop])."""
    squeeze = mel.ndim == 2
    if squeeze:
        mel = mel[None]
    hop = math.prod(up.stride[0] for up in generator.ups)
    T = mel.shape[1]
    mel = torch.nn.functional.pad(mel.float(), (0, 0, 0, shape_bucket(T, 64) - T), value=MEL_SILENCE)
    wav = generator(mel)[:, :T * hop]
    return wav[0] if squeeze else wav


def load_vocoder(cfg: dict, device) -> HifiGanGenerator:
    """The generator of the newest checkpoint in ``cfg['vocoder_ckpt']``
    (this package's format, its ``params_g``), in eval mode on ``device``."""
    ckpt = get_last_checkpoint(cfg["vocoder_ckpt"])
    if ckpt is None:
        raise FileNotFoundError(f"no vocoder checkpoint in {cfg['vocoder_ckpt']!r}")
    generator = HifiGanGenerator(
        upsample_rates=tuple(cfg.get("upsample_rates", (8, 8, 2, 2))),
        upsample_kernel_sizes=tuple(cfg.get("upsample_kernel_sizes", (16, 16, 4, 4))),
        upsample_initial_channel=cfg.get("upsample_initial_channel", 512),
        resblock_kernel_sizes=tuple(cfg.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock=str(cfg.get("resblock", "1")))
    generator.load_state_dict(load_checkpoint(ckpt, map_location="cpu")[1]["params_g"])
    return generator.to(device).eval()


def save_wav(path: str, wav: np.ndarray, sr: int = 22050) -> None:
    """Write a float waveform in [-1, 1] as 16-bit mono PCM."""
    pcm = (np.clip(np.asarray(wav), -1.0, 1.0) * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
