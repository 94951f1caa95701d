"""Dict-TTS training task: the adversarial VAE step with two optimizers.

Port of ``dicttts_tpu/train/tasks/dict_tts.py`` (``DictTTSTask``). The
generator objective is KL (times lambda_kl, clamped at kl_min) + the
composite mel loss + the word-duration loss + LSGAN-to-1 times
lambda_mel_adv; the discriminator trains on the same step's detached
output (``adv_base.py``).

The dict bank reaches S2PA in one of two ways, by the JAX package's rule:

- ``use_device_dict_bank`` with a bank (given, or from ``data.ds``), as
  the recipe sets it: the task holds the ``[V, L, E]`` bank and its maps
  on the device in the dtype they arrive in (the recipe's bank is bf16:
  ``device_bank()`` with no dtype; under amp an f32 bank is held as bf16,
  as the JAX task holds it), and batches carry word ids only. With
  ``s2pa_bank_fused`` (the recipe) S2PA runs the gather-fused kernels over
  the un-gathered bank: K1 forward, K2 backward, in the bank's dtype, with
  the query cast to it as the JAX fused branch casts it. Without it the
  bank's rows are gathered by word id in the bank's dtype and S2PA runs
  eagerly.
- gathered banks: with ``use_device_dict_bank`` off, or in a task built
  with neither data nor bank (as the inferencer builds it), batches carry
  their own ``keys`` / ``values`` [B, Tw, L, E] and ``key_map`` /
  ``pinyin`` / ``pinyin_map``. S2PA runs eagerly; in eval mode with
  ``use_pallas_s2pa`` it runs the fused kernel K3, which has no backward.

The recipe's other settings take every value the JAX task takes: ``amp``
and ``amp_bf16_activations`` (``ops/amp.py``), ``accumulate_grad_batches``
(``adv_base.py``), ``use_spk_id`` with ``num_spk`` (batches then carry
``spk_ids``), ``use_prior_glow`` (the FVAE's prior flow),
``s2pa_sense_mode`` with ``s2pa_max_senses``, ``disc_norm`` and
``disc_reduction``.

Built as ``run.py`` builds it, ``DictTTSTask(cfg, data)`` takes the bank
from ``data.ds.device_bank()`` and its batches from ``data``; with
``use_device_frame_cache`` (the recipe) train batches carry ``item_idx`` in
place of the mels (``adv_base.prepare_batch``). ``after_test_step`` and
``test_end`` write ``<work_dir>/generated/<item>.mel.npy`` (and the wav,
with ``vocoder_ckpt``) and ``meta.csv``, whose pinyin column the PER scorer
reads (``eval/per.py``). ``validation_artifacts`` gives the trainer's
TensorBoard its figures and audio.

Batch keys (the collater's): word_tokens [B, Tw], pron_modified [B, Tw],
mel2word [B, T_mel], mels [B, T_mel, 80] (or item_idx [B]),
word_lengths [B], mel_lengths [B]; with gathered banks also keys, values,
key_map, pinyin, pinyin_map.
"""

from __future__ import annotations

import csv
import logging
import os
import pickle

import numpy as np
import torch

from dicttts_tpu_torch.eval.per import decode_pinyin_ids
from dicttts_tpu_torch.models.dict_encoder import DictMsg
from dicttts_tpu_torch.models.dict_tts import DictTTS
from dicttts_tpu_torch.serve import BANK_KEYS, pinyin_decode
from dicttts_tpu_torch.train import losses as L
from dicttts_tpu_torch.train.tasks.adv_base import AdversarialTTSTask
from dicttts_tpu_torch.utils import plot
from dicttts_tpu_torch.utils.device import resolve_device
from dicttts_tpu_torch.vocoders import get_vocoder_cls
from dicttts_tpu_torch.vocoders.hifigan import save_wav

# The production recipe (configs/tts/dict_tts.yaml on ps_adv.yaml,
# ps_flow.yaml and base.yaml). tests/test_torch_train_task.py holds every
# value against the JAX package's loaded recipe.
DEFAULTS = {
    # model
    "word_size": 8000, "hidden_size": 192, "num_heads": 2, "enc_ffn_kernel_size": 5,
    "dropout": 0.1, "value_embedding_size": 185, "dict_embed_dim": 768,
    "dur_predictor_layers": 3, "dur_predictor_kernel": 5, "predictor_dropout": 0.2,
    "predictor_grad": 0.1, "frames_multiple": 4, "audio_num_mel_bins": 80, "latent_size": 16,
    "fvae_enc_dec_hidden": 192, "fvae_kernel_size": 5, "fvae_enc_n_layers": 8,
    "fvae_dec_n_layers": 4, "use_prior_glow": True, "prior_glow_hidden": 64,
    "glow_kernel_size": 3, "prior_glow_n_blocks": 4, "use_pallas_s2pa": False,
    "use_device_dict_bank": True, "s2pa_bank_fused": True, "use_spk_id": False, "num_spk": 1,
    # losses
    "mel_loss": "ssim:0.5|l1:0.5", "lambda_kl": 1.0, "kl_min": 0.002, "dur_scale": "log",
    # discriminator and GAN schedule
    "lambda_mel_adv": 0.05, "disc_start_steps": 0, "disc_interval": 1, "disc_win_num": 3,
    "mel_disc_hidden_size": 128, "disc_norm": "in", "disc_reduction": "stack",
    # optimizers
    "lr": 1.0, "warmup_updates": 8000, "optimizer_adam_beta1": 0.9, "optimizer_adam_beta2": 0.98,
    "weight_decay": 0.0, "generator_grad_norm": 1.0, "disc_lr": 1e-4,
    "discriminator_optimizer_params": {"eps": 1e-6, "weight_decay": 0.0},
    "discriminator_scheduler_params": {"step_size": 40000, "gamma": 0.5},
    "discriminator_grad_norm": 1.0, "accumulate_grad_batches": 1, "amp": False,
    # inference (test_step)
    "max_frames": 1548,
}
log = logging.getLogger("dicttts_tpu_torch.task")

# hard-coded in the JAX package (models/discriminator.py Disc2DBlockStack)
DISC_DROPOUT = 0.25

GATHERED_KEYS = ("keys", "values", "key_map", "pinyin", "pinyin_map")


class DictTTSTask(AdversarialTTSTask):
    """cfg: overrides of ``DEFAULTS`` (plus ``disc_dropout``); data: the
    batch provider (``run.py::build_data_provider``), whose ``.ds`` gives
    the device bank, or None; bank: a device bank given directly instead
    {'keys' [V, L, E], 'key_map' [V, L], 'pinyin' [V, P], 'pinyin_map'
    [V, P]} (numpy arrays, bf16 ones included, or tensors). The bank is
    held on ``device`` in the dtypes it arrives in: the keys bf16 as the
    recipe trains, or f32. With no bank (``use_device_dict_bank`` off, or
    neither data nor bank) batches carry gathered banks."""

    def __init__(self, cfg: dict | None = None, data=None, device="cuda", *, bank: dict | None = None):
        self.cfg = {**DEFAULTS, "disc_dropout": DISC_DROPOUT, **(cfg or {})}
        self.device = resolve_device(device)
        self.data = data
        self._init_adv(self.cfg)
        self.mel_loss_spec = L.parse_mel_loss_spec(self.cfg["mel_loss"])
        ds = getattr(data, "ds", None)
        want_bank = bool(self.cfg["use_device_dict_bank"])
        if bank is not None and not want_bank:
            raise ValueError("a device bank was given but use_device_dict_bank is false")
        if want_bank and bank is None and data is not None and not hasattr(ds, "device_bank"):
            raise ValueError("use_device_dict_bank=true but the data provider exposes no "
                             ".ds.device_bank (give the task run.py's provider)")
        # the JAX rule: the device bank needs the flag and a bank to hold
        self.use_device_bank = want_bank and (bank is not None or data is not None)
        self.bank_fused = self.use_device_bank and bool(self.cfg["s2pa_bank_fused"])

        def read_bank():
            b = bank if bank is not None else ds.device_bank(
                max_gloss=self.cfg.get("device_bank_max_gloss"),
                max_pinyin=self.cfg.get("device_bank_max_pinyin"))
            return {k: b[k] for k in BANK_KEYS}

        self.bank = self._hold("bank", read_bank) if self.use_device_bank else None
        if self.bank is not None and self.act_dtype is not None:
            # under amp an f32 bank is held in the activation dtype (JAX
            # train/tasks/dict_tts.py _bank_dtype)
            self.bank = {k: v.to(self.act_dtype) if v.dtype == torch.float32 else v
                         for k, v in self.bank.items()}
        self._pinyin_list = self._vocoder = None  # read at the first test batch

    def build_model(self) -> DictTTS:
        c = self.cfg
        return DictTTS(
            word_vocab=c["word_size"], hidden_size=c["hidden_size"], num_heads=c["num_heads"],
            enc_ffn_kernel_size=c["enc_ffn_kernel_size"], pinyin_vocab=c["value_embedding_size"],
            dict_embed_dim=c["dict_embed_dim"], dur_predictor_layers=c["dur_predictor_layers"],
            dur_predictor_kernel=c["dur_predictor_kernel"], frames_multiple=c["frames_multiple"],
            out_dims=c["audio_num_mel_bins"], dropout=c["dropout"],
            predictor_dropout=c["predictor_dropout"], predictor_grad=c["predictor_grad"],
            latent_size=c["latent_size"], fvae_enc_dec_hidden=c["fvae_enc_dec_hidden"],
            fvae_kernel_size=c["fvae_kernel_size"], fvae_enc_n_layers=c["fvae_enc_n_layers"],
            fvae_dec_n_layers=c["fvae_dec_n_layers"], prior_flow_hidden=c["prior_glow_hidden"],
            prior_flow_kernel_size=c["glow_kernel_size"],
            prior_flow_n_blocks=c["prior_glow_n_blocks"], use_prior_flow=bool(c["use_prior_glow"]),
            num_spk=c["num_spk"] if c["use_spk_id"] else 0, use_pallas_s2pa=c["use_pallas_s2pa"],
            s2pa_sense_mode=c.get("s2pa_sense_mode", "token"),
            s2pa_max_senses=c.get("s2pa_max_senses", 10))

    def _dict_msg(self, batch: dict) -> DictMsg:
        """The batch's gathered bank; or the device bank, un-gathered
        (``s2pa_bank_fused``) or gathered by word id in its dtype, with its
        int maps gathered by word id."""
        if self.bank is None:
            missing = [k for k in GATHERED_KEYS if k not in batch]
            if missing:
                raise ValueError(f"the task holds no device bank and the batch carries no gathered "
                                 f"bank (missing {missing})")
            return DictMsg(*(batch[k] for k in GATHERED_KEYS))
        wt = batch["word_tokens"].long()
        b = self.bank
        keys = b["keys"] if self.bank_fused else b["keys"][wt]
        return DictMsg(keys, keys, b["key_map"][wt], b["pinyin"][wt], b["pinyin_map"][wt])

    def _forward(self, batch: dict, generator=None, eps=None) -> dict:
        return self.model(batch["word_tokens"], self._dict_msg(batch), batch.get("pron_modified"),
                          mel2word=batch["mel2word"], spk_ids=batch.get("spk_ids"),
                          tgt_mels=batch["mels"], noise=eps, generator=generator)

    @torch.no_grad()
    def test_step(self, batch: dict, generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> dict:
        """Inference as the serving path runs it: predicted durations up to
        ``max_frames``, a sampled prior, and the argmax pinyin decode."""
        self.model.eval()
        dm = self._dict_msg(batch)
        with self.amp():
            out = self.model(batch["word_tokens"], dm, batch.get("pron_modified"),
                             spk_ids=batch.get("spk_ids"), max_frames=self.cfg["max_frames"],
                             noise=noise, generator=generator)
        # pron_attn is bf16 under amp (K3 rounds its outputs to q's dtype)
        return {"mel_out": out["mel_out"], "mel2word": out["mel2word"],
                "pron_attn": out["pron_attn"].float(),
                "pinyin_pred": pinyin_decode(out["pron_attn"], dm.pinyin)}

    @torch.no_grad()
    def validation_outputs(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """The card pass of ``validation_artifacts``: ``test_step`` on a
        device batch, and its first row as host arrays: the predicted mel
        cut to its predicted frames, the target mel cut to its length, and
        the pronunciation weights [Tw, P]."""
        batch = self.prepare_batch(batch)
        out = self.test_step(batch, generator)
        n = int(batch["mel_lengths"][0])
        n_pred = int((out["mel2word"][0] > 0).sum())
        return {"mel_pred": out["mel_out"][0, :n_pred].float().cpu().numpy(),
                "mel_gt": batch["mels"][0, :n].float().cpu().numpy(),
                "pron_attn": out["pron_attn"][0].cpu().numpy()}

    def validation_artifacts(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """TensorBoard figures and audio of a validation batch's first row,
        as the JAX task logs them: ``mel_gt_vs_pred`` and ``pron_attn``, and
        with ``vocoder_ckpt`` or ``log_val_audio`` the vocoded prediction
        and target (a vocoder that fails leaves the figures, with a
        warning). Needs matplotlib."""
        v = self.validation_outputs(batch, generator)
        arts = {"figures": {"mel_gt_vs_pred": plot.spec_figure(v["mel_pred"], v["mel_gt"]),
                            "pron_attn": plot.attn_figure(v["pron_attn"], "pron attention")},
                "audio": {}}
        if self.cfg.get("vocoder_ckpt") or self.cfg.get("log_val_audio", False):
            try:
                if self._vocoder is None:
                    self._vocoder = get_vocoder_cls(self.cfg.get("vocoder", "HifiGanVocoder"))(
                        self.cfg, device=self.device)
                sr = self.cfg.get("audio_sample_rate", 22050)
                arts["audio"] = {"pred": (self._vocoder.spec2wav(v["mel_pred"]), sr),
                                 "gt_mel_vocoded": (self._vocoder.spec2wav(v["mel_gt"]), sr)}
            except Exception as e:  # the figures still go out
                log.warning("validation audio failed: %r", e)
        return arts

    def after_test_step(self, batch_idx: int, batch: dict, out: dict) -> dict:
        """Write each item's mel (``<work_dir>/generated/<item>.mel.npy``, cut
        to its predicted frames) and, with ``vocoder_ckpt``, its wav; return
        the meta.csv rows. ``batch`` is the host batch with its ``_meta``,
        ``out`` the host arrays of ``test_step``."""
        cfg = self.cfg
        out_dir = os.path.join(cfg.get("work_dir") or "infer_out", "generated")
        os.makedirs(out_dir, exist_ok=True)
        if self._pinyin_list is None:
            with open(os.path.join(cfg["binary_data_dir"], "pinyin_encoder.pkl"), "rb") as f:
                self._pinyin_list = pickle.load(f)
            if cfg.get("vocoder_ckpt"):
                self._vocoder = get_vocoder_cls(cfg.get("vocoder", "HifiGanVocoder"))(
                    cfg, device=self.device)
        rows = []
        metas = batch.get("_meta") or [{}] * out["mel_out"].shape[0]
        for b, meta in enumerate(metas):
            name = meta.get("item_name", f"b{batch_idx}_{b}")
            n = int((out["mel2word"][b] > 0).sum())
            mel = out["mel_out"][b][:n]
            np.save(os.path.join(out_dir, f"{name}.mel.npy"), mel)
            wav_fn = os.path.join(out_dir, f"{name}.wav")
            if self._vocoder is not None:
                save_wav(wav_fn, self._vocoder.spec2wav(mel), cfg.get("audio_sample_rate", 22050))
            # two tokens per character, words 1..n-2 (BOS and EOS skipped)
            n_words = int((np.asarray(batch["word_tokens"])[b] > 0).sum())
            pinyin = " ".join(decode_pinyin_ids(out["pinyin_pred"][b], max(n_words - 2, 0),
                                                self._pinyin_list))
            txt = meta.get("txt", "").replace(",", "，").replace(".", "。")
            rows.append([name, txt, pinyin, wav_fn, meta.get("wav_fn_gt", "")])
        return {"rows": rows, "out_dir": out_dir}

    def test_end(self, outputs: list) -> None:
        """``meta.csv`` in the reference layout: header, then [row index,
        item_name, text, pinyin_tokens, wav_fn_pred, wav_fn_gt]."""
        if not outputs:
            return
        with open(os.path.join(outputs[0]["out_dir"], "meta.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "item_name", "text", "pinyin_tokens", "wav_fn_pred", "wav_fn_gt"])
            rows = [row for o in outputs for row in o["rows"]]
            for i, row in enumerate(rows):
                w.writerow([i, *row])
