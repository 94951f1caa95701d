"""Serving export: freeze the text -> mel (-> wav) graph into
``torch.export`` artifacts, one per (B, T_w) bucket.

Port of ``dicttts_tpu/serving_export.py``. The trained acoustic model (and
the vocoder, when given) is exported with ``torch.export`` per bucket
shape, the weights held in the artifact, so a serving process needs only
torch, this package's operators and the artifact: no model code, no
checkpoint, no tracing on the request path.

Layout:
    <out_dir>/manifest.json    buckets, shapes, device, config echo
    <out_dir>/b{B}_tw{Tw}.pt2  the exported program of that bucket

The exported function of a bucket:
    fn(word_tokens [B, Tw] i32, keys [B, Tw, L, E] f32, values [...], key_map [B, Tw, L] i32,
       pinyin [B, Tw, P] i32, pinyin_map [B, Tw, P] i32, pron_modified [B, Tw] i32,
       noise [B, max_frames / stride, latent] f32)
      -> (wav [B, max_frames * hop] f32 (with a vocoder), mel [B, max_frames, bins] f32,
          mel2word [B, max_frames] i32, pinyin_pred [B, Tw, 2] i32)

It differs from the JAX signature in one input: the prior's noise comes in
place of the int seed, because an exported program takes no
``torch.Generator``; ``ExportedTTS`` draws it from a generator seeded by
``seed``. Two limits StableHLO did not have: an artifact runs on the device
it was exported on (the manifest's ``device``), and a graph exported with
``use_pallas_s2pa`` holds K3 as the operator
``torch.ops.dicttts_tpu_torch.s2pa_fused``, so loading it needs
``dicttts_tpu_torch.ops.s2pa_fused`` imported (``ExportedTTS`` imports it).

    python -m dicttts_tpu_torch.serving_export --config <cfg> --exp_name <exp> \\
        [--out <dir>] [--buckets 1x32,8x64] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from torch import nn

import dicttts_tpu_torch.ops.s2pa_fused  # noqa: F401  (registers the operator the graphs hold)
from dicttts_tpu_torch.vocoders.hifigan import spec2wav

INPUTS = ("word_tokens", "keys", "values", "key_map", "pinyin", "pinyin_map", "pron_modified")


class _TTSGraph(nn.Module):
    """The task's ``test_step`` on gathered banks with a given prior noise,
    then the vocoder."""

    def __init__(self, task, vocoder: nn.Module | None):
        super().__init__()
        self.task = task
        self.model = task.model  # the parameters the export holds
        self.vocoder = vocoder

    def forward(self, word_tokens, keys, values, key_map, pinyin, pinyin_map, pron_modified, noise):
        batch = dict(zip(INPUTS, (word_tokens, keys, values, key_map, pinyin, pinyin_map, pron_modified)))
        out = self.task.test_step(batch, noise=noise)
        res = (out["mel_out"], out["mel2word"].to(torch.int32), out["pinyin_pred"].to(torch.int32))
        if self.vocoder is not None:
            res = (spec2wav(self.vocoder, out["mel_out"]),) + res
        return res


def export_tts(cfg: dict, task, vocoder=None, buckets=((1, 32), (8, 64)), gloss_len: int = 96,
               pinyin_len: int = 8, out_dir: str = "export") -> str:
    """Export ``task``'s test path (a ``DictTTSTask`` on gathered banks,
    its weights loaded) and the vocoder (a ``HifiGanVocoder`` or its
    generator), when given, for each (B, Tw) bucket, on the task's
    device."""
    if task.bank is not None:
        raise ValueError("the export takes gathered banks: build the task without a device bank")
    gen = getattr(vocoder, "generator", vocoder)
    os.makedirs(out_dir, exist_ok=True)
    device = task.device
    E = cfg.get("dict_embed_dim", 768)
    max_frames = cfg.get("max_frames", 512)
    fm = task.model.frames_multiple
    frames = -(-max_frames // fm) * fm
    stride = task.model.fvae.stride
    if frames % stride:
        raise ValueError(f"max_frames {frames} is not a multiple of the FVAE stride {stride}")
    latent = task.model.fvae.latent_size
    graph = _TTSGraph(task, gen).eval()
    manifest = {
        "buckets": [list(b) for b in buckets], "gloss_len": gloss_len, "pinyin_len": pinyin_len,
        "max_frames": max_frames, "hop_size": cfg.get("hop_size", 256),
        "mel_bins": cfg.get("audio_num_mel_bins", 80), "embed_dim": E, "has_vocoder": gen is not None,
        "sample_rate": cfg.get("audio_sample_rate", 22050), "device": str(device),
        "noise_shape": [frames // stride, latent],
        "note": "runs on the device it was exported on; load with dicttts_tpu_torch.ops.s2pa_fused "
                "imported (ExportedTTS does)",
    }
    for B, Tw in buckets:
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        args = (torch.zeros((B, Tw), **i32), torch.zeros((B, Tw, gloss_len, E), **f32),
                torch.zeros((B, Tw, gloss_len, E), **f32), torch.zeros((B, Tw, gloss_len), **i32),
                torch.zeros((B, Tw, pinyin_len), **i32), torch.zeros((B, Tw, pinyin_len), **i32),
                torch.zeros((B, Tw), **i32), torch.zeros((B, frames // stride, latent), **f32))
        with torch.no_grad():
            program = torch.export.export(graph, args, strict=False)
        program.example_inputs = None  # saved, the zero inputs would double an 8x64 artifact
        torch.export.save(program, os.path.join(out_dir, f"b{B}_tw{Tw}.pt2"))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class ExportedTTS:
    """Serve from an ``export_tts`` artifact (no model code): the smallest
    bucket that fits the inputs, zero-filled to it, rows [:B] returned as
    numpy arrays."""

    def __init__(self, artifact_dir: str):
        self.dir = artifact_dir
        with open(os.path.join(artifact_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.device = torch.device(self.manifest["device"])
        self._fns: dict = {}

    def module_for(self, B: int, Tw: int):
        """((Bb, Twb), the loaded module) of the smallest bucket that fits
        B rows of Tw words; loaded at its first use."""
        fit = sorted((b, tw) for b, tw in map(tuple, self.manifest["buckets"]) if b >= B and tw >= Tw)
        if not fit:
            raise ValueError(f"no exported bucket fits (B={B}, Tw={Tw}); have {self.manifest['buckets']}")
        key = fit[0]
        if key not in self._fns:
            path = os.path.join(self.dir, f"b{key[0]}_tw{key[1]}.pt2")
            self._fns[key] = torch.export.load(path).module()
        return key, self._fns[key]

    def noise(self, B: int, seed: int = 0) -> torch.Tensor:
        """The prior noise of a B-row bucket for ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((B, *self.manifest["noise_shape"]), generator=gen, device=self.device)

    def __call__(self, word_tokens, keys, values, key_map, pinyin, pinyin_map, pron_modified,
                 seed: int = 0):
        B, Tw = np.shape(word_tokens)
        (Bb, Twb), fn = self.module_for(B, Tw)
        L, P, E = self.manifest["gloss_len"], self.manifest["pinyin_len"], self.manifest["embed_dim"]

        def fit(x, shape, dtype):
            out = np.zeros(shape, dtype)
            sl = tuple(slice(0, min(a, b)) for a, b in zip(np.shape(x), shape))
            out[sl] = np.asarray(x)[sl]
            return torch.from_numpy(out).to(self.device)

        args = (fit(word_tokens, (Bb, Twb), np.int32), fit(keys, (Bb, Twb, L, E), np.float32),
                fit(values, (Bb, Twb, L, E), np.float32), fit(key_map, (Bb, Twb, L), np.int32),
                fit(pinyin, (Bb, Twb, P), np.int32), fit(pinyin_map, (Bb, Twb, P), np.int32),
                fit(pron_modified, (Bb, Twb), np.int32), self.noise(Bb, seed))
        with torch.no_grad():
            out = fn(*args)
        return tuple(o[:B].cpu().numpy() for o in out)


def main(argv=None):
    """Export a trained experiment's newest checkpoint (no vocoder, as the
    JAX command does)."""
    from dicttts_tpu_torch.config import load_config
    from dicttts_tpu_torch.run import autoconfigure_vocabs
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
    from dicttts_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

    p = argparse.ArgumentParser(description="export a Dict-TTS experiment for serving")
    p.add_argument("--config", required=True)
    p.add_argument("--exp_name", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--buckets", default="1x32,8x64")
    p.add_argument("--device", default="cuda", help="where the artifacts will run: cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = load_config(config=args.config, exp_name=args.exp_name, save=False, infer=True)
    autoconfigure_vocabs(cfg)
    cfg["use_device_dict_bank"] = False
    task = DictTTSTask(cfg, device=args.device)
    task.build_state(0)
    last = get_last_checkpoint(cfg.get("work_dir", ""))
    if not last:
        raise FileNotFoundError(f"no checkpoint under {cfg.get('work_dir')!r}")
    task.model.load_state_dict(load_checkpoint(last, map_location=task.device)[1]["params_g"])
    buckets = [tuple(map(int, b.split("x"))) for b in args.buckets.split(",")]
    out = args.out or os.path.join(cfg["work_dir"], "export")
    print(export_tts(cfg, task, buckets=buckets, out_dir=out))


if __name__ == "__main__":
    main()
