"""PortaSpeech flow training task: the non-adversarial recipe, with the
post-net Glow's two training stages.

Port of ``dicttts_tpu/train/tasks/ps_flow.py`` (``PortaSpeechFlowTask``).
``lambda_mel_adv`` is 0, so the discriminator never trains. With
``use_post_glow`` the model carries the Glow and its NLL (``postflow``):

- ``two_stage`` (the recipe): two AdamW optimizers over disjoint parts of
  the model, split by the ``post_flow`` subtree. Before
  ``post_glow_training_start`` the main losses train and only the main
  part moves; from that step on only the ``postflow`` NLL trains and only
  the Glow moves. The loss is a hard choice between the two, not a
  weighted sum. Each optimizer's moments and its schedule count tick only
  in its own stage, so the Glow's schedule (``post_glow_lr`` if set, else
  ``lr``) starts from 0 at the switch. The Glow's optimizer has optax
  ``adamw``'s default weight decay, 1e-4, as the JAX task builds it. The
  second optimizer and its count are part of ``state_dict``. The
  discriminator is not run in these steps.
- without ``two_stage`` the NLL is added to the main losses and one
  optimizer trains the whole model (``adv_base.train_step``).

A non-finite loss skips the update, as in the port's other tasks (the JAX
task multiplies NaN gradients by 0, which leaves them NaN), decided on the
card (``train/optim.py``): the step reads no device value on the host.
The stage is a gate known on the host ahead of the step, so it joins
``step_key``: a captured step of each stage (``train/graphs.py``), and the
stage-one graphs are dropped once the switch has passed.

With ``accumulate_grad_batches`` = k > 1, two-stage training accumulates
the stage's optimizer: each stage's k micro-steps make one update with
their mean gradient (``optim.GradAccumulator``), the reference trainer's
rule for every optimizer. The JAX task wraps only the main optimizer in
``MultiSteps`` and steps the Glow's at every micro-step; the port
accumulates both.
"""

from __future__ import annotations

import torch

from dicttts_tpu_torch.parallel.mesh import reduce_metrics
from dicttts_tpu_torch.train.optim import GradAccumulator, MaskedAdamW
from dicttts_tpu_torch.train.tasks.ps_adv import PortaSpeechAdvTask
from dicttts_tpu_torch.utils.schedulers import rsqrt_schedule

POST_FLOW_PREFIX = "post_flow."
POST_GLOW_WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX task's post-flow optimizer keeps


class PortaSpeechFlowTask(PortaSpeechAdvTask):
    def __init__(self, cfg: dict | None = None, data=None, device="cuda"):
        super().__init__({**(cfg or {}), "lambda_mel_adv": 0.0}, data, device)
        c = self.cfg
        self.use_post_glow = bool(c["use_post_glow"])
        self.staged = self.use_post_glow and bool(c["two_stage"])
        self.post_glow_training_start = int(c["post_glow_training_start"])
        self.schedule_pf = rsqrt_schedule(c.get("post_glow_lr", c["lr"]), c["warmup_updates"],
                                          c["hidden_size"])

    def model_kwargs(self) -> dict:
        kw = super().model_kwargs()
        if self.use_post_glow:
            c = self.cfg
            kw.update(use_post_glow=True, post_glow_hidden=c["post_glow_hidden"],
                      post_glow_kernel_size=c["post_glow_kernel_size"],
                      post_glow_n_blocks=c["post_glow_n_blocks"],
                      post_glow_n_block_layers=c["post_glow_n_block_layers"],
                      share_wn_layers=c["share_wn_layers"], sigmoid_scale=c["sigmoid_scale"],
                      use_txt_cond=c["use_txt_cond"],
                      detach_postflow_input=c["detach_postflow_input"],
                      infer_post_glow=c["infer_post_glow"], post_noise_scale=c["noise_scale"])
        return kw

    def partition(self) -> tuple[list, list]:
        """The model's parameters outside and inside the ``post_flow`` subtree."""
        named = list(self.model.named_parameters())
        return ([p for n, p in named if not n.startswith(POST_FLOW_PREFIX)],
                [p for n, p in named if n.startswith(POST_FLOW_PREFIX)])

    def _build_optimizers(self) -> None:
        super()._build_optimizers()
        if not self.staged:
            return
        c = self.cfg
        betas = (c["optimizer_adam_beta1"], c["optimizer_adam_beta2"])
        main, post = self.partition()
        self.opt_g = MaskedAdamW(main, lr=self.schedule_g(0), betas=betas, eps=1e-8,
                                 weight_decay=c["weight_decay"])
        self.opt_pf = MaskedAdamW(post, lr=self.schedule_pf(0), betas=betas, eps=1e-8,
                                  weight_decay=POST_GLOW_WEIGHT_DECAY)
        self.opt_g.init_state()
        self.opt_pf.init_state()
        if self.accumulate > 1:
            self.acc = {"g": GradAccumulator(main, self.accumulate),
                        "pf": GradAccumulator(post, self.accumulate)}

    def post_on(self) -> bool:
        """Whether the next step trains the Glow (two-stage, from
        ``post_glow_training_start``)."""
        return self.staged and self.step >= self.post_glow_training_start

    @property
    def step_key_names(self) -> tuple:
        return ("post_on",) if self.staged else super().step_key_names

    def step_key(self) -> tuple:
        """Two-stage: (post_on,), the stage of the next step; otherwise the
        adversarial gates (``adv_base``)."""
        return (self.post_on(),) if self.staged else super().step_key()

    def step_key_live(self, key: tuple) -> bool:
        """Two-stage: a stage-one step cannot come once the switch has
        passed."""
        return key[0] or not self.post_on() if self.staged else super().step_key_live(key)

    @property
    def updates_pf(self) -> int:
        return self.opt_pf.updates() if self.staged else 0

    def _gen_losses(self, batch: dict, generator=None, train: bool = True, adv_w: float = 1.0,
                    eps=None, start_frames=None):
        total, losses, out = super()._gen_losses(batch, generator, train, adv_w, eps, start_frames)
        if "postflow" in out:
            losses["postflow"] = out["postflow"]
            total = total + out["postflow"]
        return total, losses, out

    def train_step(self, batch: dict, generator: torch.Generator | None = None, *,
                   eps: torch.Tensor | None = None, start_frames_g=None, start_frames_d=None) -> dict:
        """One step. Two-stage: the main losses or, from
        ``post_glow_training_start``, the post-flow NLL, and the update of
        that stage's optimizer only. Otherwise ``adv_base.train_step``."""
        if not self.staged:
            return super().train_step(batch, generator, eps=eps, start_frames_g=start_frames_g,
                                      start_frames_d=start_frames_d)
        batch = self.prepare_batch(batch)
        post_on = self.post_on()
        self.model.train()
        self.opt_g.zero_grad(set_to_none=True)
        self.opt_pf.zero_grad(set_to_none=True)
        with self.amp():
            out = self._forward(batch, generator, eps)
        losses = {**self._main_losses(out, batch), "postflow": out["postflow"]}
        loss = out["postflow"] if post_on else sum(v for k, v in losses.items() if k != "postflow")
        loss.backward()
        metrics = {**reduce_metrics({**{k: v.detach() for k, v in losses.items()},
                                     "total_loss": loss.detach()}),
                   "post_stage": torch.full((), float(post_on), device=loss.device)}
        finite = torch.isfinite(metrics["total_loss"])  # the global loss: every rank skips alike
        main, post = self.partition()
        if post_on:
            metrics["grad_norm_pf"] = self._micro_step(
                "pf", self.opt_pf, post, self.cfg["generator_grad_norm"], self.schedule_pf, finite)
        else:
            metrics["grad_norm_g"] = self._micro_step(
                "g", self.opt_g, main, self.cfg["generator_grad_norm"], self.schedule_g, finite)
        self.step += 1
        return metrics

    def state_dict(self) -> dict:
        state = super().state_dict()
        if self.staged:
            state.update(opt_pf=self.opt_pf.state_dict(), updates_pf=self.updates_pf)
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        if self.staged:
            self.opt_pf.load_state_dict(state["opt_pf"])
            self.opt_pf.init_state()
            if self.updates_pf != int(state["updates_pf"]):
                raise ValueError(f"the checkpoint's updates_pf {state['updates_pf']} disagrees with its "
                                 f"optimizer's {self.updates_pf}")
