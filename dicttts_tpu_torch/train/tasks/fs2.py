"""FastSpeech2 training task: one optimizer, one step.

Port of ``dicttts_tpu/train/tasks/fs2.py`` (``FastSpeech2Task``). The
losses of a step, with the ground-truth mel2ph, f0 and uv fed to the
model:
- the mel loss of ``mel_loss`` ('l1', 'ssim:0.5|l1:0.5', ...), masked to
  the frames of nonzero mels;
- ``pdur``: the MSE between the phone-level log-duration prediction and
  log(d + 1) of the durations in mel2ph, over the real phones, times
  ``lambda_dur``;
- with the pitch path, ``uv``: binary cross-entropy with logits of the
  predicted uv over the real frames, and ``f0``: the MSE of the predicted
  f0 over the voiced real frames, each times ``lambda_pitch``. f0 is the
  dataset's ``norm_interp_f0`` without a mean and std, so in Hz, as in
  the JAX package: the f0 loss starts near 1e4.
The update clips the gradients to ``clip_grad_norm`` by optax's rule,
then steps AdamW (beta2 0.98, eps 1e-8, the config's weight decay) with
the rsqrt schedule read at the update count on the card
(``train/optim.MaskedAdamW``, which loads torch AdamW's checkpoints). As
in the JAX task, a non-finite loss is not guarded against. The step reads
nothing on the host, so on the card the trainer replays it as a CUDA
graph (``train/graphs.py``; ``capture_safe``); it has no gates
(``step_key`` is empty).

Under ``amp`` the model runs under autocast to bf16 where the JAX modules
take the activation dtype (``models/fastspeech2.py``); the losses run in
f32. ``use_device_frame_cache`` is refused at construction: this task has
no frame-ref batches. ``test_step`` predicts durations up to
``max_frames`` and returns mel_out and mel2ph (the task has no
``after_test_step``). Batch keys (the collater's, dataset kind 'fs'):
txt_tokens, mel2ph, mels, f0, uv, mel_lengths; with ``use_spk_id`` also
spk_ids.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dicttts_tpu_torch.models.fastspeech2 import FastSpeech2
from dicttts_tpu_torch.ops.amp import amp_scope, f32_island, task_activation_dtype
from dicttts_tpu_torch.ops.seq import mel2token_to_dur
from dicttts_tpu_torch.parallel.mesh import reduce_metrics, shard_denominator
from dicttts_tpu_torch.train import losses as L
from dicttts_tpu_torch.train.optim import MaskedAdamW
from dicttts_tpu_torch.train.tasks.adv_base import batch_to_device, optimizer_step
from dicttts_tpu_torch.utils.device import resolve_device
from dicttts_tpu_torch.utils.schedulers import rsqrt_schedule


class FastSpeech2Task:
    capture_reason = ""  # every encoder and decoder of the registry captures
    capture_safe = True
    step_key_names = ()

    def __init__(self, cfg: dict, data=None, device="cuda"):
        if cfg.get("use_device_frame_cache"):
            raise ValueError("use_device_frame_cache is not supported by FastSpeech2Task")
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        self.act_dtype = task_activation_dtype(cfg)
        self.mel_loss_spec = L.parse_mel_loss_spec(cfg.get("mel_loss", "l1"))
        self.lambda_dur = cfg.get("lambda_dur", 1.0)
        self.lambda_pitch = cfg.get("lambda_pitch", 1.0)
        self.use_pitch = cfg.get("use_pitch_embed", True)
        self.infer_max_frames = cfg.get("max_frames", 1548)
        self.schedule = rsqrt_schedule(cfg.get("lr", 2.0), cfg.get("warmup_updates", 8000),
                                       cfg.get("hidden_size", 256))

    def model_kwargs(self) -> dict:
        c = self.cfg
        return dict(
            n_vocab=c.get("n_vocab", 100), hidden_size=c.get("hidden_size", 256),
            out_dims=c.get("audio_num_mel_bins", 80), encoder_type=c.get("encoder_type", "fft"),
            decoder_type=c.get("decoder_type", "fft"), enc_layers=c.get("enc_layers", 4),
            dec_layers=c.get("dec_layers", 4), enc_ffn_kernel_size=c.get("enc_ffn_kernel_size", 9),
            dec_ffn_kernel_size=c.get("dec_ffn_kernel_size", 9), num_heads=c.get("num_heads", 2),
            dropout=c.get("dropout", 0.1), dur_predictor_layers=c.get("dur_predictor_layers", 2),
            dur_predictor_kernel=c.get("dur_predictor_kernel", 3),
            predictor_hidden=c.get("predictor_hidden", -1),
            predictor_dropout=c.get("predictor_dropout", 0.5),
            predictor_kernel=c.get("predictor_kernel", 5), predictor_grad=c.get("predictor_grad", 0.1),
            use_pitch_embed=self.use_pitch, use_uv=c.get("use_uv", True),
            pitch_norm=c.get("pitch_norm", "log"),
            num_spk=c.get("num_spk", 0) if c.get("use_spk_id") else 0)

    def build_model(self) -> FastSpeech2:
        return FastSpeech2(**self.model_kwargs())

    def build_state(self, seed: int) -> None:
        """Seeded model on the device, the optimizer, the count at 0. The
        global RNG is left as it was."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = self.build_model().to(self.device)
        c = self.cfg
        self.opt = MaskedAdamW(
            self.model.parameters(), lr=self.schedule(0), eps=1e-8,
            betas=(c.get("optimizer_adam_beta1", 0.9), c.get("optimizer_adam_beta2", 0.98)),
            weight_decay=c.get("weight_decay", 0.0))
        self.opt.init_state()
        self.step = 0

    def step_key(self) -> tuple:
        """No gates: a captured step depends on the batch's shapes alone."""
        return ()

    # -- the trainer's contract ---------------------------------------------------
    def train_batches(self):
        return self.data.train_batches()

    def val_batches(self):
        return self.data.val_batches()

    def test_batches(self):
        return self.data.test_batches()

    def attach_device_frame_cache(self) -> None:
        """FastSpeech2 batches carry their frames: nothing to upload."""

    def to_device(self, batch: dict) -> dict:
        return batch_to_device(batch, self.device)

    def amp(self):
        return amp_scope(self.device, self.act_dtype, bool(self.cfg.get("amp")))

    def f32(self):
        return f32_island(self.device.type)

    # -- losses ----------------------------------------------------------------------
    def _losses(self, batch: dict, generator=None):
        """(total, losses, model outputs) of a batch with its ground truth."""
        with self.amp():
            out = self.model(batch["txt_tokens"], batch["mel2ph"], spk_ids=batch.get("spk_ids"),
                             f0=batch.get("f0"), uv=batch.get("uv"), generator=generator)
        losses: dict = {}
        with self.f32():
            L.add_mel_losses(self.mel_loss_spec, out["mel_out"].float(), batch["mels"], losses)
            dur = out["dur"].float()
            nonpadding = (batch["txt_tokens"] > 0).float()
            dur_gt = torch.log(mel2token_to_dur(batch["mel2ph"], dur.shape[1]).float() + 1.0)
            losses["pdur"] = (torch.sum(torch.square(dur - dur_gt) * nonpadding)
                              / shard_denominator(nonpadding.sum()) * self.lambda_dur)
            if self.use_pitch:
                mel_nonpadding = (batch["mel2ph"] > 0).float()
                p_pred = out["pitch_pred"].float()
                bce = F.binary_cross_entropy_with_logits(p_pred[:, :, 1], batch["uv"], reduction="none")
                losses["uv"] = (torch.sum(bce * mel_nonpadding) / shard_denominator(mel_nonpadding.sum())
                                * self.lambda_pitch)
                f0_nonpadding = mel_nonpadding * (1 - batch["uv"])
                losses["f0"] = (torch.sum(torch.square(p_pred[:, :, 0] - batch["f0"]) * f0_nonpadding)
                                / shard_denominator(f0_nonpadding.sum()) * self.lambda_pitch)
        return sum(losses.values()), losses, out

    def train_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """One step on a device batch; ``generator`` draws the dropout
        masks. Returns the losses and the pre-clip gradient norm, as device
        scalars."""
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss, losses, _ = self._losses(batch, generator)
        loss.backward()
        norm = optimizer_step(self.opt, list(self.model.parameters()), self.cfg.get("clip_grad_norm", 1.0),
                              self.schedule(self.opt.count))
        self.step += 1
        return {**reduce_metrics({**{k: v.detach() for k, v in losses.items()},
                                  "total_loss": loss.detach()}), "grad_norm": norm}

    @torch.no_grad()
    def val_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """The losses in eval mode (no dropout)."""
        self.model.eval()
        loss, losses, _ = self._losses(batch, generator)
        losses["total_loss"] = loss
        return losses

    @torch.no_grad()
    def test_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """Predicted durations up to ``max_frames``, f32 outputs."""
        self.model.eval()
        with self.amp():
            out = self.model(batch["txt_tokens"], spk_ids=batch.get("spk_ids"),
                             max_frames=self.infer_max_frames)
        return {"mel_out": out["mel_out"].float(), "mel2ph": out["mel2ph"]}

    # -- checkpoints -------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"params_g": self.model.state_dict(), "opt_g": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["params_g"])
        self.opt.load_state_dict(state["opt_g"])  # torch AdamW's layout too
        self.opt.init_state()
        self.step = int(state["step"])
