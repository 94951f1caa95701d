"""PortaSpeech adversarial training task.

Port of ``dicttts_tpu/train/tasks/ps_adv.py`` (``PortaSpeechAdvTask``):
the generator objective is KL (times lambda_kl, clamped at kl_min) + the
composite mel loss + the word-duration loss + LSGAN-to-1 times
lambda_mel_adv against the multi-window mel discriminator, which trains on
the same step's detached output (``adv_base.py``). The word count of a
batch is the width of its ``word_tokens``. ``test_step`` predicts
durations up to ``max_frames`` and returns mel_out, mel2word and attn;
the task has no ``after_test_step``, so ``Trainer.test`` returns those
outputs as they are, as the JAX trainer does.

Batch keys (the collater's, dataset kind 'word'): txt_tokens [B, T_ph],
ph2word [B, T_ph], word_tokens [B, Tw], mel2word [B, T_mel], mels [B,
T_mel, 80], word_lengths [B], mel_lengths [B]; with ``use_spk_id`` also
spk_ids [B].
"""

from __future__ import annotations

import torch

from dicttts_tpu_torch.models.portaspeech import PortaSpeech
from dicttts_tpu_torch.train import losses as L
from dicttts_tpu_torch.train.tasks.adv_base import AdversarialTTSTask
from dicttts_tpu_torch.train.tasks.dict_tts import DISC_DROPOUT
from dicttts_tpu_torch.utils.device import resolve_device

# The recipe (configs/tts/ps_adv.yaml on ps_flow.yaml and base.yaml; the
# post-glow keys are ps_flow.yaml's). tests/test_torch_ps_task.py holds
# every value against the JAX package's loaded recipe.
DEFAULTS = {
    # model
    "n_vocab": None,  # None: word_size, as the JAX task falls back
    "word_size": 30000, "hidden_size": 192, "num_heads": 2, "enc_layers": 4, "word_enc_layers": 4,
    "enc_ffn_kernel_size": 5, "dropout": 0.1, "dur_predictor_layers": 3, "dur_predictor_kernel": 5,
    "predictor_dropout": 0.2, "predictor_grad": 0.1, "frames_multiple": 4,
    "audio_num_mel_bins": 80, "latent_size": 16, "fvae_enc_dec_hidden": 192, "fvae_kernel_size": 5,
    "fvae_enc_n_layers": 8, "fvae_dec_n_layers": 4, "use_prior_glow": True, "prior_glow_hidden": 64,
    "glow_kernel_size": 3, "prior_glow_n_blocks": 4, "use_spk_id": False, "num_spk": 1,
    # post-net glow (PortaSpeechFlowTask)
    "use_post_glow": False, "post_glow_hidden": 192, "post_glow_kernel_size": 3,
    "post_glow_n_blocks": 12, "post_glow_n_block_layers": 3, "share_wn_layers": 4,
    "sigmoid_scale": False, "use_txt_cond": True, "detach_postflow_input": True,
    "infer_post_glow": True, "noise_scale": 0.8, "post_glow_training_start": 160000,
    "two_stage": True,
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


class PortaSpeechAdvTask(AdversarialTTSTask):
    """cfg: overrides of ``DEFAULTS`` (plus ``disc_dropout``); data: the
    batch provider (``run.py::build_data_provider``) or None."""

    def __init__(self, cfg: dict | None = None, data=None, device="cuda"):
        self.cfg = {**DEFAULTS, "disc_dropout": DISC_DROPOUT, **(cfg or {})}
        self.device = resolve_device(device)
        self.data = data
        self._init_adv(self.cfg)
        self.mel_loss_spec = L.parse_mel_loss_spec(self.cfg["mel_loss"])

    def model_kwargs(self) -> dict:
        c = self.cfg
        return dict(
            n_vocab=c["n_vocab"] or c["word_size"], hidden_size=c["hidden_size"],
            num_heads=c["num_heads"], enc_layers=c["enc_layers"],
            word_enc_layers=c["word_enc_layers"], enc_ffn_kernel_size=c["enc_ffn_kernel_size"],
            dropout=c["dropout"], dur_predictor_layers=c["dur_predictor_layers"],
            dur_predictor_kernel=c["dur_predictor_kernel"],
            predictor_dropout=c["predictor_dropout"], predictor_grad=c["predictor_grad"],
            frames_multiple=c["frames_multiple"], out_dims=c["audio_num_mel_bins"],
            latent_size=c["latent_size"], fvae_enc_dec_hidden=c["fvae_enc_dec_hidden"],
            fvae_kernel_size=c["fvae_kernel_size"], fvae_enc_n_layers=c["fvae_enc_n_layers"],
            fvae_dec_n_layers=c["fvae_dec_n_layers"], use_prior_flow=bool(c["use_prior_glow"]),
            prior_flow_hidden=c["prior_glow_hidden"], prior_flow_kernel_size=c["glow_kernel_size"],
            prior_flow_n_blocks=c["prior_glow_n_blocks"],
            num_spk=c["num_spk"] if c["use_spk_id"] else 0)

    def build_model(self) -> PortaSpeech:
        return PortaSpeech(**self.model_kwargs())

    def _run_model(self, batch: dict, generator=None, infer: bool = False, noise=None,
                   post_noise=None) -> dict:
        return self.model(batch["txt_tokens"], batch["ph2word"], batch["word_tokens"].shape[1],
                          mel2word=None if infer else batch["mel2word"],
                          spk_ids=batch.get("spk_ids"), tgt_mels=None if infer else batch["mels"],
                          infer=infer, max_frames=self.cfg["max_frames"] if infer else None,
                          noise=noise, post_noise=post_noise, generator=generator)

    def _forward(self, batch: dict, generator=None, eps=None) -> dict:
        return self._run_model(batch, generator, noise=eps)

    @torch.no_grad()
    def test_step(self, batch: dict, generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None, post_noise: torch.Tensor | None = None) -> dict:
        """Inference: predicted durations up to ``max_frames``, the FVAE's
        prior sample (``noise``) and, with the post-net Glow, its sample
        (``post_noise``); either drawn from ``generator`` when not given."""
        self.model.eval()
        with self.amp():
            out = self._run_model(batch, generator, infer=True, noise=noise, post_noise=post_noise)
        return {"mel_out": out["mel_out"], "mel2word": out["mel2word"], "attn": out["attn"]}
