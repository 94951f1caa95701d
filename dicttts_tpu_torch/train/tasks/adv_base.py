"""Shared GAN machinery for acoustic-model tasks with the multi-window mel
discriminator.

Port of ``dicttts_tpu/train/tasks/adv_base.py`` (``AdversarialTTSTask``).
Subclasses provide the generator (``build_model``) and its training pass
(``_forward``); this base owns the losses, the discriminator, both AdamW
optimizers with their schedules, and the two-optimizer train step.

One step, as in the JAX package:

1. the generator loss, with the adversarial term scored by the *current*
   discriminator, whose parameters are frozen for that pass so its
   backward leaves them no gradient;
2. the discriminator loss on this step's detached generator output, real
   and fake in one stacked pass with shared crop starts;
3. the updates: each optimizer clips to its global norm by optax's rule
   (scale by max/norm when norm >= max), then steps AdamW with the
   schedule read at its own update count. A non-finite generator loss
   skips the generator update and leaves its optimizer untouched (under
   data parallelism the global loss decides, so every rank skips); while
   the discriminator is gated off (step < disc_start_steps, or step %
   disc_interval != 0) its optimizer and schedule do not step.

The step never reads a device value on the host and allocates no state
after its first run, so a CUDA graph can capture it (``train/graphs.py``):
the skip is decided on the card (``MaskedAdamW``, ``train/optim.py``: on a
non-finite loss the weights, both moments and the update count keep their
bits), the update counts are the optimizers' device counts (``updates_g``
and ``updates_d`` read them), and the schedules read them there. The gates
are known on the host ahead of the step; they and the batch's shapes key a
captured step (``step_key``). ``grad_norm_g`` is reported on a skipped
step too. MaskedAdamW is optax's ``adamw`` rule: bias-corrected moments,
eps added to the root of the second moment, decoupled weight decay applied
as lr * wd * param. Parameters that got no gradient are stepped with a
zero gradient, as optax does.

``accumulate_grad_batches`` = k > 1 is optax ``MultiSteps`` around both
optimizers, as in the JAX package, decided on the card as well
(``optim.GradAccumulator``): each micro-step folds its gradients into a
running mean (optax's Welford rule, acc += (g - acc) / (n + 1)) where its
loss is finite, and n counts the micro-steps folded; the update is tried
at every micro-step on that mean and applied only where n reaches k, which
also resets the mean and n. A micro-step therefore runs the same graph
wherever it falls in the k. ``step`` (and with it ``disc_start_steps`` and
``disc_interval``) counts micro-steps, the update counts count optimizer
steps. A skipped generator micro-step (non-finite loss) and a gated-off
discriminator leave their accumulation state as it was, micro-step count
included, so the two can fall out of phase. ``grad_norm_*`` is the
pre-clip norm of the running mean at every micro-step. The accumulators
are part of ``state_dict``.

Under ``amp`` (``ops/amp.py``) the model and discriminator passes run under
autocast to bf16; the losses are computed with autocast off, on f32
values. Parameters and optimizer state stay f32.

Under data parallelism (``parallel/mesh.py``) each rank steps on its rows
of the global batch: the losses are W times their shares of the global
batch's, the gradients are averaged over the ranks once per update
try (with accumulation that is every micro-step: the running mean is
averaged, and only the k-th micro-step's average is applied), and the
reported losses are the global batch's.

Batches reach the steps through ``to_device`` (host arrays to tensors on
the task's device, through pinned memory on the card, transfer dtypes
upcast) and ``prepare_batch``, which
resolves frame-ref batches (``use_device_frame_cache``: ``item_idx`` in
place of the mels) from the frame cache that ``attach_device_frame_cache``
uploads once.
"""

from __future__ import annotations

import contextlib
import logging
import time

import numpy as np
import torch

from dicttts_tpu_torch.models.discriminator import MultiWindowDiscriminator
from dicttts_tpu_torch.ops.amp import amp_scope, f32_island, task_activation_dtype
from dicttts_tpu_torch.ops.s2pa_bank import bank_tensor
from dicttts_tpu_torch.parallel.mesh import all_reduce_grads, reduce_metrics
from dicttts_tpu_torch.train import losses as L
from dicttts_tpu_torch.train.optim import GradAccumulator, MaskedAdamW
from dicttts_tpu_torch.utils.schedulers import rsqrt_schedule, step_decay_schedule

log = logging.getLogger("dicttts_tpu_torch.task")


def upcast_transfer_dtypes(batch: dict) -> dict:
    """float16 entries (mels under amp) to float32 and int16 ones (frame-ref
    alignments) to int32, as the JAX package's ``upcast_transfer_dtypes``;
    other entries unchanged."""
    def up(v):
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.float16:
                return v.float()
            if v.dtype == torch.int16:
                return v.int()
        return v

    return {k: up(v) for k, v in batch.items()}


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: multiply every gradient by
    max_norm / norm when the global norm >= max_norm. Returns the norm
    before clipping, as a device scalar."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def optimizer_step(opt, params, max_norm: float, lr, apply: torch.Tensor | None = None) -> torch.Tensor:
    """One optax-style update of ``params``: a parameter without a gradient
    steps with zero, the gradients are averaged over the data-parallel
    ranks (one collective; none without a process group), clipped to
    ``max_norm`` by their global norm, the lr is set, the optimizer steps.
    A ``MaskedAdamW`` takes the lr as a device tensor too, and applies the
    update only where the device bool ``apply`` is true (None: always).
    Returns the pre-clip norm."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_grads(params)
    norm = clip_by_global_norm_([p.grad for p in params], max_norm)
    if isinstance(opt, MaskedAdamW):
        opt.update(lr, apply)
        return norm
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return norm


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Host arrays (or tensors) to tensors on ``device``, with the transfer
    dtypes upcast; other entries (``_meta``) pass through. To the card they
    go from pinned memory without blocking the host (torch's host allocator
    holds a pinned buffer until its copy ends)."""
    def put(v):
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            return (t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True)
        return t.to(device)

    return upcast_transfer_dtypes({
        k: put(v) if isinstance(v, (np.ndarray, torch.Tensor)) else v for k, v in batch.items()})


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """Run a forward whose backward must leave ``module``'s parameters no
    gradient."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield module
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


class AdversarialTTSTask:
    """Base: generator + multi-window mel discriminator training. Subclasses
    set ``cfg``, ``device``, ``data`` (the batch provider, or None) and
    ``mel_loss_spec``, and give ``build_model()`` and ``_forward()``."""

    frame_cache: dict | None = None  # {'mels' [N, T, 80], ('f0', 'uv' [N, T])} on the device

    def _init_adv(self, cfg: dict) -> None:
        self.lambda_adv = cfg["lambda_mel_adv"]
        self.disc_start_steps = cfg["disc_start_steps"]
        self.disc_interval = cfg["disc_interval"]
        self.schedule_g = rsqrt_schedule(cfg["lr"], cfg["warmup_updates"], cfg["hidden_size"])
        sched = cfg["discriminator_scheduler_params"]
        self.schedule_d = step_decay_schedule(cfg["disc_lr"], sched["step_size"], sched["gamma"])
        self.accumulate = int(cfg["accumulate_grad_batches"])
        if self.accumulate < 1:
            raise ValueError(f"accumulate_grad_batches must be >= 1, got {self.accumulate}")
        self.act_dtype = task_activation_dtype(cfg)
        self.uploads: dict = {}  # what _hold put on the device: bytes and seconds by name

    def amp(self):
        """The scope of the model and discriminator passes (``ops/amp.py``)."""
        return amp_scope(self.device, self.act_dtype, bool(self.cfg.get("amp")))

    def f32(self):
        """The scope of the losses: autocast off."""
        return f32_island(self.device.type)

    def _build_disc(self) -> MultiWindowDiscriminator:
        cfg = self.cfg
        return MultiWindowDiscriminator(
            time_lengths=(32, 64, 128)[:cfg["disc_win_num"]],
            freq_length=cfg["audio_num_mel_bins"], hidden_size=cfg["mel_disc_hidden_size"],
            dropout_rate=cfg["disc_dropout"], norm_type=cfg["disc_norm"],
            reduction=cfg["disc_reduction"])

    def _build_optimizers(self) -> None:
        cfg = self.cfg
        betas = (cfg["optimizer_adam_beta1"], cfg["optimizer_adam_beta2"])
        opt_p = cfg["discriminator_optimizer_params"]
        self.opt_g = MaskedAdamW(self.model.parameters(), lr=self.schedule_g(0), betas=betas,
                                 eps=1e-8, weight_decay=cfg["weight_decay"])
        self.opt_d = MaskedAdamW(self.disc.parameters(), lr=self.schedule_d(0), betas=betas,
                                 eps=opt_p["eps"], weight_decay=opt_p["weight_decay"])
        # every state a step reads exists before the first step, never
        # allocated inside a captured one
        self.opt_g.init_state()
        self.opt_d.init_state()
        self.step = 0  # train steps (micro-steps) taken
        # gradient accumulation (k > 1): each optimizer's running mean and count
        self.acc = {}
        if self.accumulate > 1:
            self.acc = {"g": GradAccumulator(self.model.parameters(), self.accumulate),
                        "d": GradAccumulator(self.disc.parameters(), self.accumulate)}

    capture_reason = ""  # why the step cannot be captured ("" : it can)
    step_key_names = ("adv_on", "disc_on")

    @property
    def capture_safe(self) -> bool:
        """The train step reads nothing on the host and allocates no state
        after its warm-up, in every setting (accumulation, amp, the gates),
        so the trainer may replay it as a CUDA graph (``train/graphs.py``)."""
        return not self.capture_reason

    @property
    def updates_g(self) -> int:
        """Generator updates applied (the schedule's count; a host read)."""
        return self.opt_g.updates()

    @property
    def updates_d(self) -> int:
        return self.opt_d.updates()

    def step_key(self) -> tuple[bool, bool]:
        """The next train step's gates, (adv_on, disc_on): the adversarial
        term from disc_start_steps on, the discriminator's update on every
        disc_interval-th of those steps. Known on the host ahead of the
        step, they are what its captured graph depends on besides the
        batch's shapes and dtypes."""
        adv_on = self.step >= self.disc_start_steps and self.lambda_adv > 0
        return adv_on, adv_on and self.step % self.disc_interval == 0

    def step_key_live(self, key: tuple) -> bool:
        """Whether a step of ``key`` (``step_key``) can still come: a
        generator-only step (adv_on false) cannot once the discriminator
        has started."""
        return key[0] or self.step < self.disc_start_steps or self.lambda_adv <= 0

    def build_state(self, seed: int) -> None:
        """Seeded generator (``build_model()``) and discriminator on the
        device, the optimizers, counters at 0. The global RNG is left as it
        was."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = self.build_model().to(self.device)
            self.disc = self._build_disc().to(self.device)
        self._build_optimizers()

    def train_batches(self):
        return self.data.train_batches()

    def val_batches(self):
        return self.data.val_batches()

    def test_batches(self):
        return self.data.test_batches()

    def _hold(self, name: str, make) -> dict:
        """``make()``'s arrays as tensors on the device; its build and upload
        times and its bytes are logged and kept in ``self.uploads[name]``."""
        t0 = time.perf_counter()
        host = make()
        t1 = time.perf_counter()
        held = {k: bank_tensor(v, self.device) for k, v in host.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n_bytes = sum(v.numel() * v.element_size() for v in held.values())
        self.uploads[name] = {"bytes": n_bytes, "build_s": t1 - t0,
                              "upload_s": time.perf_counter() - t1}
        log.info("%s: %.1f MB on %s (built in %.2f s, uploaded in %.2f s)", name, n_bytes / 1e6,
                 self.device, t1 - t0, self.uploads[name]["upload_s"])
        return held

    def attach_device_frame_cache(self) -> None:
        """With ``use_device_frame_cache``, upload the train split's frame
        cache (``data.ds.device_frame_cache``) once."""
        if not self.cfg.get("use_device_frame_cache") or self.frame_cache is not None:
            return
        ds = getattr(self.data, "ds", None)
        if not hasattr(ds, "device_frame_cache"):
            # the train provider emits item_idx-only batches under the flag
            raise ValueError("use_device_frame_cache=true but the data provider exposes no "
                             ".ds.device_frame_cache (unset the flag, or give the task run.py's "
                             "provider)")
        self.frame_cache = self._hold(
            "frame_cache", lambda: ds.device_frame_cache(max_frames=self.cfg.get("max_frames")))

    def to_device(self, batch: dict) -> dict:
        return batch_to_device(batch, self.device)

    def prepare_batch(self, batch: dict) -> dict:
        """Resolve a frame-ref batch: gather each row's mels (and f0/uv) from
        the frame cache by ``item_idx``, cut to the batch's bucket (the
        width of mel2word) and zeroed at and after the row's mel_lengths.
        Pad rows carry item 0 with length 0, so they get zero mels, as a
        streamed batch's pad rows have; without the mask they would train
        toward item 0's mel. Real rows are zero past their length in the
        cache already, so a gathered batch equals the streamed one."""
        if "item_idx" not in batch:
            return batch
        if self.frame_cache is None:
            raise ValueError("a frame-ref batch (item_idx), but the task holds no frame cache")
        batch = dict(batch)
        idx = batch.pop("item_idx").long()
        T = batch["mel2word"].shape[-1]
        fmask = torch.arange(T, device=idx.device)[None, :] < batch["mel_lengths"][:, None]
        for key, cache in self.frame_cache.items():
            rows = cache[:, :T].index_select(0, idx)
            mask = fmask[..., None] if rows.ndim == 3 else fmask
            batch[key] = rows * mask.to(rows.dtype)
        return upcast_transfer_dtypes(batch)

    # subclass contract:
    #   build_model() -> the generator;
    #   _forward(batch, generator, eps) -> its training outputs (kl, mel_out, dur, ...)

    def _main_losses(self, out: dict, batch: dict) -> dict:
        """KL (times lambda_kl, clamped at kl_min), the composite mel loss
        (``self.mel_loss_spec``) and the word-duration loss, in f32."""
        with self.f32():
            losses = {"kl": L.clamp_kl(out["kl"].float() * self.cfg["lambda_kl"], self.cfg["kl_min"])}
            L.add_mel_losses(self.mel_loss_spec, out["mel_out"], batch["mels"], losses)
            losses["wdur"] = L.word_dur_loss(out["dur"].float(), batch["mel2word"],
                                             batch["word_lengths"], self.cfg["dur_scale"])
        return losses

    def _gen_losses(self, batch: dict, generator=None, train: bool = True, adv_w: float = 1.0,
                    eps=None, start_frames=None):
        """(total, losses, model outputs): the main losses, plus in training
        the adversarial term times lambda_mel_adv and ``adv_w``."""
        with self.amp():
            out = self._forward(batch, generator, eps)
        losses = self._main_losses(out, batch)
        if train and self.lambda_adv > 0:
            losses["a"] = (self._adv_gen_loss(out["mel_out"], batch["mel_lengths"], generator,
                                              start_frames) * self.lambda_adv * adv_w)
        return sum(losses.values()), losses, out

    def _adv_gen_loss(self, mel_pred, mel_lengths, generator=None, start_frames=None):
        """LSGAN-to-1 term of the generator objective; the discriminator is
        frozen, so the backward reaches the generator only."""
        with frozen(self.disc), self.amp():
            d_out = self.disc(mel_pred, mel_lengths, start_frames, generator)
        with self.f32():
            y = d_out["y"].float()
            return L.row_mean(torch.square(y - 1.0) * d_out["win_valid"][None, :], mel_lengths)

    def _disc_losses(self, mel_fake, mel_real, lengths, generator=None, start_frames=None):
        """Real and fake in one stacked pass, crop starts shared."""
        B = mel_real.shape[0]
        with self.amp():
            out = self.disc(torch.cat([mel_real, mel_fake]), torch.cat([lengths, lengths]),
                            start_frames, generator)
        with self.f32():
            y = out["y"].float()
            wv = out["win_valid"][None, :]
            loss_r = L.row_mean(torch.square(y[:B] - 1.0) * wv, lengths)
            loss_f = L.row_mean(torch.square(y[B:]) * wv, lengths)
        return loss_r + loss_f, {"r": loss_r, "f": loss_f}

    def _micro_step(self, name: str, opt, params, max_norm: float, schedule,
                    finite: torch.Tensor | None = None) -> torch.Tensor:
        """Apply this micro-step's gradients (``.grad``; None counts as zero,
        as optax counts it) to optimizer ``name``, with its lr ``schedule``
        read at its device count. k = 1: the update, applied where the
        device bool ``finite`` is true (None: always). k > 1: fold them into
        the running mean where ``finite``, and try the update on the mean,
        applied (and the mean reset) where it holds k micro-steps. Returns
        the pre-clip norm of the gradients the update was tried with."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        acc = self.acc.get(name)
        apply = finite if acc is None else acc.fold(finite)
        norm = optimizer_step(opt, params, max_norm, schedule(opt.count), apply)
        if acc is not None:
            acc.reset(apply)
        return norm

    def train_step(self, batch: dict, generator: torch.Generator | None = None, *,
                   eps: torch.Tensor | None = None, start_frames_g=None, start_frames_d=None) -> dict:
        """One GAN step on a device batch. ``generator`` draws the dropout
        masks, the posterior noise and the crop starts; ``eps`` and the two
        sets of crop starts (the generator's adversarial term, the
        discriminator loss) may be given instead. Returns the losses, and
        the pre-clip gradient norm of each parameter set whose update was
        tried (the generator's also where the card skipped it), as device
        scalars."""
        batch = self.prepare_batch(batch)
        adv_on, disc_on = self.step_key()
        self.model.train()
        self.disc.train()
        self.opt_g.zero_grad(set_to_none=True)
        self.opt_d.zero_grad(set_to_none=True)
        loss_g, g_losses, out = self._gen_losses(batch, generator, True, float(adv_on), eps,
                                                 start_frames_g)
        loss_g.backward()
        with torch.set_grad_enabled(disc_on):
            loss_d, d_losses = self._disc_losses(out["mel_out"].detach(), batch["mels"],
                                                 batch["mel_lengths"], generator, start_frames_d)
        if disc_on:
            loss_d.backward()
        # the global batch's losses: every rank takes the same skip decision
        metrics = reduce_metrics({**{k: v.detach() for k, v in {**g_losses, **d_losses}.items()},
                                  "total_loss": loss_g.detach(), "disc_loss": loss_d.detach()})
        finite = torch.isfinite(metrics["total_loss"])
        metrics["grad_norm_g"] = self._micro_step(
            "g", self.opt_g, list(self.model.parameters()), self.cfg["generator_grad_norm"],
            self.schedule_g, finite)
        if disc_on:
            metrics["grad_norm_d"] = self._micro_step(
                "d", self.opt_d, list(self.disc.parameters()), self.cfg["discriminator_grad_norm"],
                self.schedule_d)
        self.step += 1
        return metrics

    @torch.no_grad()
    def val_step(self, batch: dict, generator: torch.Generator | None = None,
                 eps: torch.Tensor | None = None) -> dict:
        """Generator losses in eval mode (no dropout, no adversarial term)."""
        batch = self.prepare_batch(batch)
        self.model.eval()
        _, losses, _ = self._gen_losses(batch, generator, False, eps=eps)
        losses["total_loss"] = sum(losses.values())
        return losses

    def state_dict(self) -> dict:
        """Everything a resume needs, the accumulators (k > 1) included;
        device constants (the bank) excluded."""
        state = {"params_g": self.model.state_dict(), "params_d": self.disc.state_dict(),
                 "opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict(),
                 "step": self.step, "updates_g": self.updates_g, "updates_d": self.updates_d}
        for name, acc in self.acc.items():
            state[f"acc_{name}"] = acc.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        """The update counts come with the optimizers' states (their
        ``step``); ``updates_g`` / ``updates_d`` must agree with them."""
        self.model.load_state_dict(state["params_g"])
        self.disc.load_state_dict(state["params_d"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.opt_g.init_state()
        self.step = int(state["step"])
        if (self.updates_g, self.updates_d) != (int(state["updates_g"]), int(state["updates_d"])):
            raise ValueError(f"the checkpoint's update counts {state['updates_g']}, {state['updates_d']} "
                             f"disagree with its optimizers' {self.updates_g}, {self.updates_d}")
        self.opt_d.init_state()
        for name, acc in self.acc.items():
            acc.load_state_dict(state[f"acc_{name}"])
