"""Dict-TTS training task: the adversarial VAE step with two optimizers.

Port of ``dicttts_tpu/train/tasks/dict_tts.py`` (``DictTTSTask``). The
generator objective is KL (times lambda_kl, clamped at kl_min) + the
composite mel loss + the word-duration loss + LSGAN-to-1 times
lambda_mel_adv; the discriminator trains on the same step's detached
output (``adv_base.py``).

As the recipe sets it (``use_device_dict_bank``, ``s2pa_bank_fused``),
the task holds the ``[V, L, E]`` bank and its maps on the card in the dtype
they arrive in (the recipe's bank is bf16: ``device_bank()`` with no dtype),
batches carry word ids only, and S2PA runs the gather-fused kernels over
the un-gathered bank: K1 forward, K2 backward, in the bank's dtype, with
the query cast to it as the JAX fused branch casts it. Batches that carry
gathered banks are not ported.

Batch keys (the collater's): word_tokens [B, Tw], pron_modified [B, Tw],
mel2word [B, T_mel], mels [B, T_mel, 80], word_lengths [B],
mel_lengths [B].
"""

from __future__ import annotations

import torch

from dicttts_tpu_torch.models.dict_encoder import DictMsg
from dicttts_tpu_torch.models.dict_tts import DictTTS
from dicttts_tpu_torch.ops.s2pa_bank import bank_tensor
from dicttts_tpu_torch.serve import BANK_KEYS, pinyin_decode, resolve_device
from dicttts_tpu_torch.train import losses as L
from dicttts_tpu_torch.train.tasks.adv_base import AdversarialTTSTask

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
    "use_device_dict_bank": True, "s2pa_bank_fused": True, "use_spk_id": False,
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
# hard-coded in the JAX package (models/discriminator.py Disc2DBlockStack)
DISC_DROPOUT = 0.25

# settings the JAX package supports and this port does not yet
_REQUIRED = {"use_prior_glow": True, "use_spk_id": False, "accumulate_grad_batches": 1,
             "amp": False, "use_device_dict_bank": True, "s2pa_bank_fused": True,
             "disc_norm": "in", "disc_reduction": "stack"}


class DictTTSTask(AdversarialTTSTask):
    """cfg: overrides of ``DEFAULTS`` (plus ``disc_dropout``); bank: the
    device bank {'keys' [V, L, E], 'key_map' [V, L], 'pinyin' [V, P],
    'pinyin_map' [V, P]} (numpy arrays, bf16 ones included, or tensors),
    held on ``device`` in the dtypes it arrives in: the keys bf16 as the
    recipe trains, or f32."""

    def __init__(self, cfg: dict | None = None, bank: dict | None = None, device="cuda"):
        self.cfg = {**DEFAULTS, "disc_dropout": DISC_DROPOUT, **(cfg or {})}
        for key, value in _REQUIRED.items():
            if self.cfg[key] != value:
                raise ValueError(f"the port supports only {key}={value!r}, got {self.cfg[key]!r}")
        self.device = resolve_device(device)
        self._init_adv(self.cfg)
        self.mel_loss_spec = L.parse_mel_loss_spec(self.cfg["mel_loss"])
        self.bank = None
        if bank is not None:
            self.bank = {k: bank_tensor(bank[k], self.device) for k in BANK_KEYS}

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
            prior_flow_n_blocks=c["prior_glow_n_blocks"], use_pallas_s2pa=c["use_pallas_s2pa"])

    def build_state(self, seed: int) -> None:
        """Seeded generator and discriminator on the device, both optimizers,
        counters at 0. The global RNG is left as it was."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = self.build_model().to(self.device)
            self.disc = self._build_disc().to(self.device)
        self._build_optimizers()

    def to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _dict_msg(self, batch: dict) -> DictMsg:
        """The device bank, un-gathered, with its int maps gathered by word id."""
        if self.bank is None:
            raise ValueError("the task holds no dict bank")
        wt = batch["word_tokens"].long()
        b = self.bank
        return DictMsg(b["keys"], b["keys"], b["key_map"][wt], b["pinyin"][wt], b["pinyin_map"][wt])

    def _gen_losses(self, batch: dict, generator=None, train: bool = True, adv_w: float = 1.0,
                    eps=None, start_frames=None):
        out = self.model(batch["word_tokens"], self._dict_msg(batch), batch.get("pron_modified"),
                         mel2word=batch["mel2word"], tgt_mels=batch["mels"], noise=eps,
                         generator=generator)
        losses = {"kl": L.clamp_kl(out["kl"] * self.cfg["lambda_kl"], self.cfg["kl_min"])}
        L.add_mel_losses(self.mel_loss_spec, out["mel_out"], batch["mels"], losses)
        losses["wdur"] = L.word_dur_loss(out["dur"], batch["mel2word"], batch["word_lengths"],
                                         self.cfg["dur_scale"])
        if train and self.lambda_adv > 0:
            losses["a"] = (self._adv_gen_loss(out["mel_out"], batch["mel_lengths"], generator,
                                              start_frames) * self.lambda_adv * adv_w)
        return sum(losses.values()), losses, out

    @torch.no_grad()
    def test_step(self, batch: dict, generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> dict:
        """Inference as the serving path runs it: predicted durations up to
        ``max_frames``, a sampled prior, and the argmax pinyin decode."""
        self.model.eval()
        dm = self._dict_msg(batch)
        out = self.model(batch["word_tokens"], dm, batch.get("pron_modified"),
                         max_frames=self.cfg["max_frames"], noise=noise, generator=generator)
        return {"mel_out": out["mel_out"], "mel2word": out["mel2word"],
                "pron_attn": out["pron_attn"], "pinyin_pred": pinyin_decode(out["pron_attn"], dm.pinyin)}
