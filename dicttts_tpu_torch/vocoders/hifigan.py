"""HiFi-GAN inference: ``spec2wav``, the registered ``HifiGanVocoder``,
``save_wav`` and ``load_wav``, as in ``dicttts_tpu/vocoders/hifigan.py``.

The mel length is padded up to a multiple of 64 frames with the log10-mel
silence floor (-6.0, not 0.0, which would be loud energy bleeding into the
tail through the generator's receptive field), vocoded, and cropped back
to ``T * hop`` samples.

``HifiGanVocoder(cfg)`` builds the generator at the config's widths from
the newest checkpoint in ``cfg['vocoder_ckpt']``, or from a seeded init
when there is none, as the JAX class does. With ``vocoder_infer_dtype:
bfloat16`` the weights and the input are bf16 and the wav comes back f32.
"""

from __future__ import annotations

import logging
import math
import wave

import numpy as np
import torch

from dicttts_tpu_torch.data.collate import shape_bucket
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.ops.mel import log10_mel
from dicttts_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint
from dicttts_tpu_torch.utils.device import resolve_device
from dicttts_tpu_torch.vocoders.base_vocoder import BaseVocoder, register_vocoder

MEL_SILENCE = -6.0  # log10(1e-6), the mel floor
INFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

log = logging.getLogger("dicttts_tpu_torch.vocoder")


@torch.no_grad()
def spec2wav(generator: HifiGanGenerator, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, 80] (or [T, 80]) -> wav [B, T * hop] (or [T * hop]), f32.
    The mel is padded in f32 and fed in the generator's dtype."""
    squeeze = mel.ndim == 2
    if squeeze:
        mel = mel[None]
    hop = math.prod(up.stride[0] for up in generator.ups)
    T = mel.shape[1]
    mel = torch.nn.functional.pad(mel.float(), (0, 0, 0, shape_bucket(T, 64) - T), value=MEL_SILENCE)
    wav = generator(mel.to(generator.conv_pre.weight.dtype))[:, :T * hop].float()
    return wav[0] if squeeze else wav


def save_wav(path: str, wav: np.ndarray, sr: int = 22050) -> None:
    """Write a float waveform in [-1, 1] as 16-bit mono PCM."""
    pcm = (np.clip(np.asarray(wav), -1.0, 1.0) * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """16-bit PCM file -> (float32 waveform in [-1, 1), sample rate)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        data = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
    return data.astype(np.float32) / 32768.0, sr


def build_generator(cfg: dict) -> HifiGanGenerator:
    """A generator at the config's widths (the recipe's by default), drawn
    from the global RNG."""
    return HifiGanGenerator(
        upsample_rates=tuple(cfg.get("upsample_rates", (8, 8, 2, 2))),
        upsample_kernel_sizes=tuple(cfg.get("upsample_kernel_sizes", (16, 16, 4, 4))),
        upsample_initial_channel=cfg.get("upsample_initial_channel", 512),
        resblock_kernel_sizes=tuple(cfg.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock=str(cfg.get("resblock", "1")))


@register_vocoder
class HifiGanVocoder(BaseVocoder):
    """cfg: the generator's widths, ``vocoder_ckpt`` (a directory of this
    package's checkpoints, their ``params_g``) and ``vocoder_infer_dtype``;
    params: a generator state dict given directly instead of a checkpoint;
    seed: the init's seed when there is neither. Runs on ``device``."""

    def __init__(self, cfg: dict, params: dict | None = None, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.infer_dtype = cfg.get("vocoder_infer_dtype", "float32")
        if self.infer_dtype not in INFER_DTYPES:
            raise ValueError(f"vocoder_infer_dtype must be one of {sorted(INFER_DTYPES)}, "
                             f"got {self.infer_dtype!r}")
        if params is None and cfg.get("vocoder_ckpt"):
            last = get_last_checkpoint(cfg["vocoder_ckpt"])
            if last:
                params = load_checkpoint(last, map_location="cpu")[1]["params_g"]
            else:
                log.warning("no vocoder checkpoint in %r: a seeded init (seed %d) vocodes",
                            cfg["vocoder_ckpt"], seed)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            generator = build_generator(cfg)
        if params is not None:
            generator.load_state_dict(params)
        # the parameters are cast once here; the JAX class casts at dispatch
        self.generator = generator.to(self.device, INFER_DTYPES[self.infer_dtype]).eval()
        self.hop = math.prod(up.stride[0] for up in self.generator.ups)

    def spec2wav(self, mel) -> np.ndarray:
        """mel [T, 80] or [B, T, 80] (numpy, or a tensor on any device) ->
        f32 wav numpy."""
        mel = torch.as_tensor(mel, dtype=torch.float32).to(self.device)
        return spec2wav(self.generator, mel).cpu().numpy()

    @staticmethod
    def wav2spec(wav_fn, cfg: dict | None = None):
        """wav path or float array -> (wav cut to a whole number of frames,
        its log10 mel [T, n_mels]), on the CPU."""
        cfg = cfg or {}
        if isinstance(wav_fn, str):
            wav, _ = load_wav(wav_fn)
        else:
            wav = np.asarray(wav_fn, np.float32)
        hop = cfg.get("hop_size", 256)
        mel = log10_mel(
            torch.from_numpy(wav), sample_rate=cfg.get("audio_sample_rate", 22050),
            n_fft=cfg.get("fft_size", 1024), hop=hop, win_length=cfg.get("win_size", 1024),
            n_mels=cfg.get("audio_num_mel_bins", 80), fmin=cfg.get("fmin", 80.0),
            fmax=cfg.get("fmax", 7600.0)).numpy()
        # align the wav to a whole number of frames (pad, then truncate)
        wav = np.pad(wav, (0, max(0, mel.shape[0] * hop - len(wav))))
        return wav[: mel.shape[0] * hop], mel
