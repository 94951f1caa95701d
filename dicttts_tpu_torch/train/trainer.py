"""Max-updates trainer: the task's train step over a stream of batches,
validation every ``val_check_interval`` steps, rotated checkpoints and
resume.

Port of the single-device loop of ``dicttts_tpu/train/trainer.py``. Each
step's randomness (dropout masks, the posterior noise, crop starts) comes
from a ``torch.Generator`` seeded by (seed, step), so a resumed run draws
what the uninterrupted run would have drawn. The device bank and other
task constants are not checkpointed. Not ported: the scan grouping of
steps, prefetch, the device mesh, best-checkpoint tracking and the
TensorBoard writer.

    trainer = Trainer(work_dir, max_updates=1000)          # device="cuda"
    trainer.fit(task, train_batches, val_batches)
"""

from __future__ import annotations

import logging
from typing import Iterable

import torch

from dicttts_tpu_torch.serve import resolve_device
from dicttts_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint, save_checkpoint

log = logging.getLogger("dicttts_tpu_torch.trainer")


class Trainer:
    def __init__(self, work_dir: str, max_updates: int = 1000, val_check_interval: int = 2000,
                 num_ckpt_keep: int = 3, log_interval: int = 100, seed: int = 1234,
                 device="cuda"):
        self.work_dir = work_dir
        self.max_updates = max_updates
        self.val_check_interval = val_check_interval
        self.num_ckpt_keep = num_ckpt_keep
        self.log_interval = log_interval
        self.seed = seed
        self.device = resolve_device(device)
        self.global_step = 0
        self.metrics: dict = {}  # the last train step's losses (device scalars)
        self.val_metrics: dict = {}

    def step_generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + step)

    def fit(self, task, train_batches: Iterable[dict], val_batches: Iterable[dict] = ()) -> None:
        """Train ``task`` (a ``DictTTSTask`` on this trainer's device) to
        ``max_updates``, resuming from the newest checkpoint in work_dir.
        ``train_batches`` is iterated again from the start when it runs out."""
        if task.device != self.device:
            raise ValueError(f"task on {task.device}, trainer on {self.device}")
        task.build_state(self.seed)
        last = get_last_checkpoint(self.work_dir)
        if last:
            self.global_step, state = load_checkpoint(last, map_location=self.device)
            task.load_state_dict(state)
            log.info("resumed from %s @ step %d", last, self.global_step)
        saved_at = self.global_step
        while self.global_step < self.max_updates:
            n_batches = 0
            for batch in train_batches:
                if self.global_step >= self.max_updates:
                    break
                n_batches += 1
                self.metrics = task.train_step(task.to_device(batch),
                                               self.step_generator(self.global_step))
                self.global_step += 1
                if self.global_step % self.log_interval == 0:
                    log.info("step %d | %s", self.global_step,
                             " ".join(f"{k}={float(v):.4f}" for k, v in self.metrics.items()))
                if self.global_step % self.val_check_interval == 0:
                    self.val_metrics = self.evaluate(task, val_batches)
                    self.save(task)
                    saved_at = self.global_step
            if n_batches == 0:
                raise ValueError(f"train_batches yielded nothing at step {self.global_step}")
        if saved_at != self.global_step:
            self.save(task)

    def evaluate(self, task, val_batches: Iterable[dict]) -> dict:
        """Validation losses, each batch weighted by its sentence count."""
        sums: dict = {}
        count = 0
        for i, batch in enumerate(val_batches):
            batch = task.to_device(batch)
            n = batch["word_tokens"].shape[0]
            gen = torch.Generator(device=self.device).manual_seed(self.seed + i)
            for k, v in task.val_step(batch, gen).items():
                sums[k] = sums.get(k, 0.0) + float(v) * n
            count += n
        means = {k: v / max(count, 1) for k, v in sums.items()}
        if means:
            log.info("validation @ %d: %s", self.global_step, means)
        return means

    def save(self, task) -> str:
        return save_checkpoint(self.work_dir, self.global_step, task.state_dict(),
                               keep=self.num_ckpt_keep)
