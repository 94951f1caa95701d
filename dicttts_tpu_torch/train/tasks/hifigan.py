"""HiFi-GAN vocoder training: the two-optimizer GAN step.

Port of ``dicttts_tpu/train/tasks/hifigan.py`` (``HifiGanTask``). One step:

1. the generator: ``lambda_mel`` x L1 between the HiFi-GAN log-mels
   (``ops/mel.gan_log_mel``) of the generated and the real crop, plus the
   LSGAN term of the multi-period and multi-scale discriminators scored on
   the generated wav, times ``lambda_adv``; the discriminators' parameters
   are frozen for that pass, so its backward leaves them no gradient.
   Before ``disc_start_steps`` the adversarial term is still computed, times
   0. Optional: feature matching (``use_fm_loss``, also times 0 before the
   start) and the multi-resolution STFT loss (``use_ms_stft``);
2. the discriminators' LSGAN loss on the real crop and on the detached
   generated wav;
3. the updates: each optimizer clips to its global norm by optax's rule
   (10 for G, 1 for D), then steps AdamW as ``optax.adamw`` (b1 0.8, b2
   0.99, eps 1e-8, weight decay 1e-4, not torch's 1e-2 default) with the
   StepLR schedule lr * gamma^floor(count / step_size) read at its own
   update count, on the card (``train/optim.MaskedAdamW``: the counts are
   the optimizers' device counts, which ``updates_g`` and ``updates_d``
   read; torch AdamW's checkpoints load). Before ``disc_start_steps`` the
   discriminators' optimizer does not step: its moments and its count stay
   as they were.

The step reads nothing on the host, so on the card the trainer replays it
as a CUDA graph (``train/graphs.py``). Whether the discriminators train is
known on the host ahead of the step (``step_key``); the generator-only
graphs are dropped once they have started (``step_key_live``).

Under ``amp`` the generator and discriminator passes run under autocast to
bf16 (the JAX task casts both parameter sets to bf16 at use) and return
f32 wavs, scores and feature maps; the log-mel L1, the STFT loss, LSGAN and
feature matching run in f32. Parameters and optimizer state stay f32.

Batches ({'wavs' [B, max_samples], 'mels' [B, max_samples // hop, 80]}) come
from ``data.datasets.VocoderDataset``. ``test_step`` returns the generated
wav of the whole mel, in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from dicttts_tpu_torch.models.hifigan import (
    HifiGanDiscriminator,
    HifiGanGenerator,
    discriminator_adv_loss,
    generator_adv_loss,
)
from dicttts_tpu_torch.ops.amp import amp_scope, f32_island, task_activation_dtype
from dicttts_tpu_torch.ops.mel import gan_log_mel
from dicttts_tpu_torch.parallel.mesh import reduce_metrics
from dicttts_tpu_torch.train.losses import feature_matching_loss
from dicttts_tpu_torch.train.optim import MaskedAdamW
from dicttts_tpu_torch.train.stft_loss import multi_resolution_stft_loss
from dicttts_tpu_torch.train.tasks.adv_base import frozen, optimizer_step
from dicttts_tpu_torch.utils.device import resolve_device
from dicttts_tpu_torch.utils.schedulers import step_decay_schedule

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


class HifiGanTask:
    capture_reason = ""
    capture_safe = True
    step_key_names = ("disc_on",)

    def __init__(self, cfg: dict, data=None, device="cuda"):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        self.act_dtype = task_activation_dtype(cfg)
        self.lambda_mel = cfg.get("lambda_mel", 5.0)
        self.lambda_adv = cfg.get("lambda_adv", 1.0)
        self.use_fm = cfg.get("use_fm_loss", False)
        self.use_ms_stft = cfg.get("use_ms_stft", False)
        self.disc_start_steps = cfg.get("disc_start_steps", 40000)
        self.mel_kw = dict(sample_rate=cfg.get("audio_sample_rate", 22050), n_fft=cfg.get("fft_size", 1024),
                           hop=cfg.get("hop_size", 256), win_length=cfg.get("win_size", 1024),
                           n_mels=cfg.get("audio_num_mel_bins", 80), fmin=cfg.get("fmin", 80.0),
                           fmax=cfg.get("fmax", 7600.0))
        g_opt = cfg.get("generator_optimizer_params", {"lr": 2e-4})
        g_sched = cfg.get("generator_scheduler_params", {"step_size": 600, "gamma": 0.999})
        d_opt = cfg.get("discriminator_optimizer_params", {"lr": 2e-4})
        d_sched = cfg.get("discriminator_scheduler_params", {"step_size": 600, "gamma": 0.999})
        self.schedule_g = step_decay_schedule(g_opt["lr"], g_sched["step_size"], g_sched["gamma"])
        self.schedule_d = step_decay_schedule(d_opt["lr"], d_sched["step_size"], d_sched["gamma"])

    def build_generator(self) -> HifiGanGenerator:
        cfg = self.cfg
        return HifiGanGenerator(
            upsample_rates=tuple(cfg.get("upsample_rates", (8, 8, 2, 2))),
            upsample_kernel_sizes=tuple(cfg.get("upsample_kernel_sizes", (16, 16, 4, 4))),
            upsample_initial_channel=cfg.get("upsample_initial_channel", 512),
            resblock_kernel_sizes=tuple(cfg.get("resblock_kernel_sizes", (3, 7, 11))),
            resblock=str(cfg.get("resblock", "1")), in_channels=self.mel_kw["n_mels"])

    def build_state(self, seed: int) -> None:
        """Seeded generator and discriminators on the device, both
        optimizers, counters at 0. The global RNG is left as it was."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = self.build_generator().to(self.device)
            self.disc = HifiGanDiscriminator().to(self.device)
        betas = (self.cfg.get("adam_b1", 0.8), self.cfg.get("adam_b2", 0.99))
        self.opt_g = MaskedAdamW(self.model.parameters(), lr=self.schedule_g(0), betas=betas,
                                 eps=1e-8, weight_decay=ADAMW_WEIGHT_DECAY)
        self.opt_d = MaskedAdamW(self.disc.parameters(), lr=self.schedule_d(0), betas=betas,
                                 eps=1e-8, weight_decay=ADAMW_WEIGHT_DECAY)
        self.opt_g.init_state()
        self.opt_d.init_state()
        self.step = 0

    @property
    def updates_g(self) -> int:
        """Generator updates applied (the schedule's count; a host read)."""
        return self.opt_g.updates()

    @property
    def updates_d(self) -> int:
        return self.opt_d.updates()

    def step_key(self) -> tuple[bool]:
        """(disc_on,): whether the next step trains the discriminators."""
        return (self.step >= self.disc_start_steps,)

    def step_key_live(self, key: tuple) -> bool:
        """A generator-only step cannot come once the discriminators train."""
        return key[0] or self.step < self.disc_start_steps

    # -- the trainer's contract ---------------------------------------------------
    def train_batches(self):
        return self.data.train_batches()

    def val_batches(self):
        return self.data.val_batches()

    def test_batches(self):
        return self.data.test_batches()

    def attach_device_frame_cache(self) -> None:
        """Vocoder batches carry their crops: nothing to upload."""

    def to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device).float() if isinstance(v, (np.ndarray, torch.Tensor))
                else v for k, v in batch.items()}

    def amp(self):
        return amp_scope(self.device, self.act_dtype, bool(self.cfg.get("amp")))

    def f32(self):
        return f32_island(self.device.type)

    # -- losses ----------------------------------------------------------------------
    def _disc_scores(self, wav):
        """Scores and feature maps of every sub-discriminator, in f32."""
        with self.amp():
            scores, fmaps = self.disc(wav)
        return [s.float() for s in scores], [[f.float() for f in fm] for fm in fmaps]

    def _gen_losses(self, batch: dict, train: bool):
        """(total, losses, wav_fake): the generator's objective."""
        with self.amp():
            wav_fake = self.model(batch["mels"]).float()
        wav_real = batch["wavs"]
        with self.f32():
            losses = {"mel": self.lambda_mel * torch.mean(torch.abs(
                gan_log_mel(wav_fake, **self.mel_kw) - gan_log_mel(wav_real, **self.mel_kw)))}
        disc_on = float(self.step_key()[0])
        if train:
            with frozen(self.disc):
                scores_f, fmaps_f = self._disc_scores(wav_fake)
                if self.use_fm:
                    with torch.no_grad():
                        _, fmaps_r = self._disc_scores(wav_real)
            with self.f32():
                losses["a"] = generator_adv_loss(scores_f) * self.lambda_adv * disc_on
                if self.use_fm:
                    losses["fm"] = feature_matching_loss(fmaps_r, fmaps_f) * disc_on
        if self.use_ms_stft:
            with self.f32():
                losses["sc"], losses["mag"] = multi_resolution_stft_loss(wav_real, wav_fake)
        return sum(losses.values()), losses, wav_fake

    def _disc_loss(self, wav_fake, wav_real):
        scores_r, _ = self._disc_scores(wav_real)
        scores_f, _ = self._disc_scores(wav_fake)
        with self.f32():
            return discriminator_adv_loss(scores_r, scores_f)

    def train_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """One GAN step on a device batch (``generator`` is unused: the step
        draws nothing). Returns the losses and the pre-clip gradient norm of
        each parameter set that was updated, as device scalars."""
        (disc_on,) = self.step_key()
        self.model.train()
        self.disc.train()
        self.opt_g.zero_grad(set_to_none=True)
        self.opt_d.zero_grad(set_to_none=True)
        loss_g, losses, wav_fake = self._gen_losses(batch, True)
        loss_g.backward()
        metrics = {"grad_norm_g": optimizer_step(self.opt_g, list(self.model.parameters()),
                                                 self.cfg.get("generator_grad_norm", 10.0),
                                                 self.schedule_g(self.opt_g.count))}
        with torch.set_grad_enabled(disc_on):
            loss_d = self._disc_loss(wav_fake.detach(), batch["wavs"])
        if disc_on:
            loss_d.backward()
            metrics["grad_norm_d"] = optimizer_step(self.opt_d, list(self.disc.parameters()),
                                                    self.cfg.get("discriminator_grad_norm", 1.0),
                                                    self.schedule_d(self.opt_d.count))
        self.step += 1
        return {**reduce_metrics({**{k: v.detach() for k, v in losses.items()},
                                  "total_loss": loss_g.detach(), "disc_loss": loss_d.detach()}),
                **metrics}

    @torch.no_grad()
    def val_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """The generator's losses without the adversarial terms."""
        self.model.eval()
        _, losses, _ = self._gen_losses(batch, False)
        losses["total_loss"] = sum(losses.values())
        return losses

    @torch.no_grad()
    def test_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        self.model.eval()
        return {"wav_out": self.model(batch["mels"].float())}

    def after_test_step(self, batch_idx: int, batch: dict, out: dict) -> dict:
        return out

    def test_end(self, outputs: list) -> None:
        pass

    # -- checkpoints -------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"params_g": self.model.state_dict(), "params_d": self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict(),
                "step": self.step, "updates_g": self.updates_g, "updates_d": self.updates_d}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["params_g"])
        self.disc.load_state_dict(state["params_d"])
        self.opt_g.load_state_dict(state["opt_g"])  # torch AdamW's layout too
        self.opt_d.load_state_dict(state["opt_d"])
        self.opt_g.init_state()
        self.opt_d.init_state()
        self.step = int(state["step"])
        if (self.updates_g, self.updates_d) != (int(state["updates_g"]), int(state["updates_d"])):
            raise ValueError(f"the checkpoint's update counts {state['updates_g']}, {state['updates_d']} "
                             f"disagree with its optimizers' {self.updates_g}, {self.updates_d}")
