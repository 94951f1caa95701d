"""Max-updates trainer: the task's train step over the provider's batches,
sanity and periodic validation, rotated and best checkpoints, resume, and
the test loop.

Port of the single-device loop of ``dicttts_tpu/train/trainer.py``:

- ``fit(task)`` reads ``task.train_batches()`` through a prefetch thread,
  starting it again at each epoch's end, validates on
  ``num_sanity_val_steps`` batches before the first step (those count for
  nothing), validates every ``val_check_interval`` steps on up to
  ``eval_max_batches`` batches and saves; after the last step it validates
  and saves once more unless that step just did. Validation means weight
  each batch by its sentence count. The best checkpoint by
  ``monitor_key`` / ``monitor_mode`` is kept beside the rotated ones, and
  its value is read back on resume.
- ``test(task)`` runs ``task.test_step`` over ``task.test_batches()`` from
  the newest checkpoint, then the task's ``after_test_step`` / ``test_end``
  where it has them (the PortaSpeech tasks have neither).

Each step's randomness (dropout masks, the posterior noise, crop starts)
comes from a ``torch.Generator`` seeded by (seed, step, rank), so a resumed
run draws what the uninterrupted run would have drawn. Device constants
(the bank, the frame cache) are not checkpointed.

Data parallelism (the JAX trainer's mesh; ``parallel/mesh.py``): under a
process group every rank builds the same global batches from the same
seed, pads each to a multiple of the world size with zero rows and steps
on its own rows; after the build or the resume rank 0's weights and
optimizer state are broadcast. The tasks' steps average the gradients and
report the global batch's losses. Validation reduces each batch's metrics
over the ranks and weights them by the global batch's sentences, so it
gives one process's numbers. Rank 0 alone writes checkpoints, TensorBoard
and the test outputs; every rank resumes from the same newest checkpoint.

With ``tensorboardX`` installed (it is optional, as in the JAX trainer)
rank 0 writes ``<work_dir>/tb``: the ``tr/*`` scalars (the step's losses
and ``steps_per_sec``) every ``log_interval`` steps, the ``val/*`` means at
each validation, and every ``valid_infer_interval`` steps (by default each
validation) the task's ``validation_artifacts`` of the first validation
batch: figures and audio. An artifact that fails logs a warning and never
stops training.

Steps are grouped as the JAX trainer groups them (its
``steps_per_dispatch``, K): consecutive batches of one shape join a group
until it holds K, the next batch's shape differs (that batch starts the
next group), or the group reaches a validation mark or ``max_updates``.
One difference: a re-queued batch that itself reaches ``max_updates``
runs as a group of its own at once, where the JAX trainer joins it with
the next batch of its shape and steps past ``max_updates``. (A re-queued
batch at a validation mark joins the next batch as in the JAX trainer, and
the group validates one step past the mark.)
Logging fires when a group crosses a multiple of ``log_interval``
(``global_step % log_interval < n_ran``) with the group's last step's
metrics; validation, the checkpoint and the artifacts when it crosses a
multiple of ``val_check_interval``. Inside a group the host reads nothing
from the card; a group ends with one synchronization, and the metrics are
read only where it logs or validates. On the card at K > 1, every step
of a task that declares its step capture-safe (``capture_safe``: every
task of ``train/tasks`` -- Dict-TTS, the PortaSpeech pair in both stages,
FastSpeech2 with each encoder and decoder, HiFi-GAN -- with or without
gradient accumulation and amp) runs through ``train/graphs.py``: a key's
first step eagerly, then replays of the step's CUDA graph. A task that is
not capture-safe runs its steps eagerly, and its ``capture_reason`` goes
into ``graph_report`` (``not_captured``) and into each history record
(``why_eager``). On the CPU a group's steps run eagerly. K = 1 is one
eager step a group: the same step, the same numbers. Under data
parallelism only NCCL's collectives can be captured: a capture-safe task
with K > 1 on the card under gloo raises.

Each step's randomness (dropout masks, the posterior noise, crop starts)
is a function of (seed, step, rank), whatever K is: ``step_generator``
eagerly, the graphs' generator seeded alike before each replay. This
differs on purpose from the JAX trainer, which splits a group's per-step
keys from one key per group, so that there K changes the draws.

``steady_per_step_s`` is the JAX trainer's pipelined seconds a step: the
clock restarts after the first group's synchronization, and validation,
checkpoint and artifact time is left out; None after a single group.

Checkpoints are written on a thread beside the next steps
(``utils/checkpoint.CheckpointWriter``): ``save`` takes a bit-exact
snapshot of the state on the card, then returns; the thread copies it to
the host and writes it. A pending write is joined before the next save,
at the end of ``fit``, before ``test`` and before a resume reads the
directory, and before the final barrier. ``saves`` records, per save, the
milliseconds ``save`` held the loop and the thread's seconds.

Each train step appends a record to ``history``: the step, its sentences
and mel frames (the batch's shape), the milliseconds the loop waited for
the batch, its group's index and size, how it ran (``run``: "eager",
"captured" (the capture, then its first replay) or "replayed"; with
``why_eager`` where a task that is not capture-safe ran eagerly on the
card at K > 1), and ``step_ms``: the group's wall time, from its first
step's launch to its end synchronization, divided by its steps. ``graph_report`` holds the graphs of the last ``fit`` (keys,
capture seconds, replays, bank-kernel nodes).

    trainer = Trainer(work_dir, max_updates=1000, steps_per_dispatch=16)   # device="cuda"
    trainer.fit(task)
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time
from typing import Iterable

import numpy as np
import torch

from dicttts_tpu_torch.parallel import mesh
from dicttts_tpu_torch.utils.checkpoint import (CheckpointWriter, get_last_checkpoint, load_checkpoint,
                                                read_extras, snapshot)
from dicttts_tpu_torch.utils.device import resolve_device
from dicttts_tpu_torch.utils.prefetch import prefetch_iterator

log = logging.getLogger("dicttts_tpu_torch.trainer")


def _host(batch: dict) -> dict:
    """A batch without its host-only ``_meta``."""
    return {k: v for k, v in batch.items() if k != "_meta"}


def _shard(batch: dict) -> dict:
    """This rank's rows of a host batch, padded with zero rows to a
    multiple of the world size first (both the identity in one process)."""
    return mesh.shard_batch(mesh.pad_batch_to_devices(_host(batch), mesh.world_size()))


def batch_rows(batch: dict) -> int:
    """A batch's sentences (or crops): its arrays' leading dimension."""
    return int(np.shape(next(v for k, v in batch.items() if k != "_meta"))[0])


def batch_frames(batch: dict) -> int:
    """A batch's mel frames: mel2word's width (TTS batches), else the mels'."""
    return int(np.shape(batch["mel2word"] if "mel2word" in batch else batch["mels"])[1])


def _pinned(v):
    """A host array as a tensor in pinned memory (other entries kept)."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, torch.Tensor) and v.device.type == "cpu":
        return v.pin_memory()
    return v


class _SteadyClock:
    """The JAX trainer's pipelined seconds a step: counted from the end of
    the first group (its synchronization; the group holds the first steps'
    set-up), the blocks in ``left_out`` (validation, checkpoints, artifacts)
    left out."""

    def __init__(self):
        self.start: float | None = None
        self.steps = 0
        self.excluded = 0.0

    def ran(self, n: int) -> None:
        """A group of ``n`` steps ended with its synchronization."""
        if self.start is None:
            self.start = time.perf_counter()
        else:
            self.steps += n

    def _elapsed(self) -> float:
        return time.perf_counter() - self.start - self.excluded

    @contextlib.contextmanager
    def left_out(self):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.excluded += time.perf_counter() - t

    def steps_per_sec(self) -> float:
        return self.steps / max(self._elapsed(), 1e-9)

    def per_step(self) -> float | None:
        """None after a single group."""
        return self._elapsed() / self.steps if self.steps else None


class Trainer:
    def __init__(self, work_dir: str, max_updates: int = 1000, val_check_interval: int = 2000,
                 num_sanity_val_steps: int = 5, num_ckpt_keep: int = 3, log_interval: int = 100,
                 eval_max_batches: int = -1, monitor_key: str = "total_loss",
                 monitor_mode: str = "min", save_best: bool = True, seed: int = 1234,
                 device="cuda", valid_infer_interval: int | None = None, steps_per_dispatch: int = 1):
        if monitor_mode not in ("min", "max"):
            raise ValueError(f"monitor_mode must be 'min' or 'max', got {monitor_mode!r}")
        self.work_dir = work_dir
        self.max_updates = max_updates
        self.val_check_interval = val_check_interval
        self.num_sanity_val_steps = num_sanity_val_steps
        self.num_ckpt_keep = num_ckpt_keep
        self.log_interval = log_interval
        self.eval_max_batches = eval_max_batches
        self.monitor_key = monitor_key
        self.monitor_mode = monitor_mode
        self.save_best = save_best
        self.seed = seed
        self.device = resolve_device(device)
        self.global_step = 0
        self.best_val = math.inf if monitor_mode == "min" else -math.inf
        self.metrics: dict = {}  # the last train step's losses (device scalars)
        self.val_metrics: dict = {}
        self.history: list[dict] = []  # one record per train step of this fit
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)  # K: the most steps in a group
        self.steady_per_step_s: float | None = None
        self.graph_report: dict | None = None  # the last fit's CUDA graphs (train/graphs.py)
        self._why_eager: str | None = None  # why this fit's steps run eagerly on the card at K > 1
        self.saves: list[dict] = []  # per save: step, hold_ms (the loop's), write_s (the thread's)
        self._ckpt_writer = CheckpointWriter()
        self.test_seconds = 0.0  # the last test loop's wall time
        # figures and audio cost more than the scalar validation: their own interval
        self.valid_infer_interval = valid_infer_interval or val_check_interval
        self._writer = None  # the TensorBoard writer: None until asked for, False if unavailable

    def _generator(self, seed: int) -> torch.Generator:
        """A generator for ``seed`` with this rank folded in (rank 0's is
        the single-process one): each rank draws for its own rows. The
        rank moves the seed within its low 32 bits, the only ones the CPU
        generator reads, by a large odd stride."""
        return torch.Generator(device=self.device).manual_seed(seed + mesh.rank() * 2_654_435_761)

    def step_seed(self, step: int) -> int:
        """The seed of train step ``step``'s generator on this rank."""
        return self.seed * 1_000_003 + step + mesh.rank() * 2_654_435_761

    def step_generator(self, step: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.step_seed(step))

    def writer(self):
        """Rank 0's ``tensorboardX`` writer on ``<work_dir>/tb``; None on the
        other ranks, without a work dir, or where tensorboardX is not
        installed."""
        if self._writer is None:
            self._writer = False
            if mesh.is_chief() and self.work_dir:
                try:
                    from tensorboardX import SummaryWriter
                except ImportError:
                    log.info("tensorboardX is not installed: no TensorBoard logs")
                else:
                    self._writer = SummaryWriter(logdir=os.path.join(self.work_dir, "tb"))
        return self._writer or None

    def log_metrics(self, metrics: dict, prefix: str) -> None:
        writer = self.writer()
        if writer:
            for k, v in metrics.items():
                writer.add_scalar(f"{prefix}/{k}", float(v), self.global_step)

    def join_pending_save(self) -> None:
        """Wait for the background checkpoint write, if one is pending."""
        self._ckpt_writer.join()

    def _restore(self, task) -> None:
        """Build the task's state; load the newest checkpoint, if any."""
        self.join_pending_save()
        task.build_state(self.seed)
        last = get_last_checkpoint(self.work_dir)
        if last:
            self.global_step, state = load_checkpoint(last, map_location=self.device)
            task.load_state_dict(state)
            best = read_extras(last).get("best_val")
            if best is not None:
                self.best_val = float(best)
            log.info("resumed from %s @ step %d (best_val=%s)", last, self.global_step, best)

    def fit(self, task, train_batches: Iterable[dict] | None = None,
            val_batches: Iterable[dict] | None = None) -> None:
        """Train ``task`` (a task of ``train/tasks`` on this trainer's device) to
        ``max_updates``, resuming from the newest checkpoint in work_dir.
        The batches are the task's (``task.train_batches()``, read again
        each epoch, and ``task.val_batches()``), or the iterables given
        (train batches iterated again from the start when they run out; no
        validation batches unless given)."""
        if task.device != self.device:
            raise ValueError(f"task on {task.device}, trainer on {self.device}")
        if train_batches is None:
            train, val = task.train_batches, task.val_batches
        else:
            train, val = (lambda: train_batches), (lambda: val_batches or ())
        self._restore(task)
        mesh.broadcast_state(task.state_dict())
        task.attach_device_frame_cache()
        k = self.steps_per_dispatch
        runner = None
        self._why_eager = None
        if self.device.type == "cuda" and k > 1:
            if getattr(task, "capture_safe", False):
                mesh.check_graph_capture(f"steps_per_dispatch={k}")
                from dicttts_tpu_torch.train.graphs import StepGraphs
                runner = StepGraphs(task, self.device)
            else:
                self._why_eager = (getattr(task, "capture_reason", "")
                                   or f"{type(task).__name__} does not declare its step capture-safe")
                log.warning("steps run eagerly: %s", self._why_eager)
                self.graph_report = {"graphs": [], "replays": 0, "capture_s": 0.0, "eager_steps": 0,
                                     "not_captured": self._why_eager}
        if self.num_sanity_val_steps > 0 and self.global_step == 0:
            self.evaluate(task, val(), max_batches=self.num_sanity_val_steps, sanity=True)
        saved_at = self.global_step
        clock = _SteadyClock()
        group: list = []  # (prepared batch, seconds waited for it)
        n_groups = 0
        try:
            while self.global_step < self.max_updates:
                n_batches = 0
                with contextlib.closing(prefetch_iterator(map(self._prepare, train()), depth=8)) as batches:
                    while self.global_step < self.max_updates:
                        t0 = time.perf_counter()
                        item = next(batches, None)
                        if item is None:
                            break
                        n_batches += 1
                        group.append((item, time.perf_counter() - t0))
                        ends = self._group_ends(group, k)
                        while ends:
                            same_shape = group[-1][0][3] == group[0][0][3]
                            requeue = [] if same_shape else [group.pop()]  # the odd batch starts the next group
                            n_ran = len(group)
                            self._run_group(task, group, runner, n_groups)
                            group, n_groups = requeue, n_groups + 1
                            clock.ran(n_ran)
                            if self.global_step % self.log_interval < n_ran:
                                sps = clock.steps_per_sec()
                                self.log_metrics({**self.metrics, "steps_per_sec": sps}, "tr")
                                log.info("step %d | %s | %.2f it/s", self.global_step, " ".join(
                                    f"{k_}={float(v):.4f}" for k_, v in self.metrics.items()), sps)
                            if self.global_step % self.val_check_interval < n_ran:
                                with clock.left_out():
                                    self.save(task, self.evaluate(task, val()))
                                    saved_at = self.global_step
                                    if self.global_step % self.valid_infer_interval < n_ran:
                                        self.log_artifacts(task, val())
                            # a re-queued batch that reaches max_updates runs at once, never past it
                            ends = bool(group) and self.global_step + len(group) >= self.max_updates
                if n_batches == 0:
                    raise ValueError(f"train_batches yielded nothing at step {self.global_step}")
            self.steady_per_step_s = clock.per_step()
            if runner is not None:
                self.metrics = {k_: v.clone() for k_, v in self.metrics.items()}  # out of the graphs' pool
                self.graph_report = runner.report()
                runner.release()
                runner = None
            if saved_at != self.global_step:
                self.save(task, self.evaluate(task, val()))
        finally:
            if runner is not None:
                runner.release()
            self.join_pending_save()
        if self._writer:
            self._writer.close()
        self._writer = None
        mesh.barrier()  # every rank leaves after rank 0's last checkpoint

    def _group_ends(self, group: list, k: int) -> bool:
        """The JAX trainer's rule: a group ends when it holds K batches, its
        last batch's shape differs from its first's, or it reaches a
        validation mark or max_updates."""
        ahead = self.global_step + len(group)
        return (len(group) >= k or group[-1][0][3] != group[0][0][3]
                or ahead % self.val_check_interval == 0 or ahead >= self.max_updates)

    def _prepare(self, batch: dict) -> tuple:
        """The prefetch thread's work on a host batch: this rank's rows
        (``_shard``), in pinned memory on the card's host; with its
        sentences, frames and shapes (the grouping key)."""
        host = _host(batch)
        shapes = tuple((k, np.shape(v)) for k, v in host.items())
        prepared = _shard(batch)
        if self.device.type == "cuda":
            prepared = {k: _pinned(v) for k, v in prepared.items()}
        return prepared, batch_rows(batch), batch_frames(batch), shapes

    def _run_group(self, task, group: list, runner, index: int) -> None:
        """Run a group's steps, eagerly or by graph replay, with no host
        read; then one synchronization, and one history record a step."""
        t0 = time.perf_counter()
        records = []
        for (batch, rows, frames, _), wait in group:
            if runner is None:
                self.metrics = task.train_step(task.to_device(batch), self.step_generator(self.global_step))
            else:
                self.metrics = runner.step(batch, self.step_seed(self.global_step))
            self.global_step += 1
            records.append({"step": self.global_step, "sentences": rows, "frames": frames,
                            "wait_ms": wait * 1e3, "group": index, "group_size": len(group),
                            "run": runner.last if runner is not None else "eager"})
            if self._why_eager:
                records[-1]["why_eager"] = self._why_eager
                self.graph_report["eager_steps"] += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        step_ms = (time.perf_counter() - t0) * 1e3 / len(group)
        for r in records:
            r["step_ms"] = step_ms
        self.history.extend(records)

    def evaluate(self, task, val_batches: Iterable[dict], max_batches: int | None = None,
                 sanity: bool = False) -> dict:
        """Validation losses over up to ``max_batches`` batches
        (``eval_max_batches`` if None; <= 0: all), each batch weighted by its
        sentence count. Batch i draws from a generator seeded by (seed, i,
        rank), so two validations of one state agree. Under data
        parallelism each batch's metrics are reduced over the ranks and
        weighted by the global batch's sentences."""
        max_batches = self.eval_max_batches if max_batches is None else max_batches
        results = []
        for i, batch in enumerate(val_batches):
            if 0 < max_batches <= i:
                break
            n = batch_rows(batch)
            metrics = task.val_step(task.to_device(_shard(batch)), self._generator(self.seed + i))
            results.append((mesh.reduce_metrics(metrics), n))
        sums: dict = {}
        count = 0
        for metrics, n in results:  # one host read per value, after every batch is queued
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v) * n
            count += n
        means = {k: v / max(count, 1) for k, v in sums.items()}
        log.info("%s @ %d: %s", "sanity validation" if sanity else "validation", self.global_step,
                 means)
        if not sanity:
            self.val_metrics = means
            self.log_metrics(means, "val")
        return means

    def log_artifacts(self, task, val_batches: Iterable[dict]) -> None:
        """The task's ``validation_artifacts(batch, generator) -> {'figures':
        {name: Figure}, 'audio': {name: (wav, sr)}}`` of the first
        validation batch, to TensorBoard (rank 0, with a writer). A failure
        logs a warning and never stops training."""
        writer = self.writer()
        if writer is None or not hasattr(task, "validation_artifacts"):
            return
        try:
            batch = task.to_device(_host(next(iter(val_batches))))
            arts = task.validation_artifacts(batch, torch.Generator(device=self.device).manual_seed(self.seed))
            for name, (wav, sr) in arts.get("audio", {}).items():
                writer.add_audio(name, np.asarray(wav)[:, None], self.global_step, sample_rate=sr)
            for name, fig in arts.get("figures", {}).items():
                writer.add_figure(name, fig, self.global_step)
        except Exception as e:  # artifacts must never stop training
            log.warning("validation artifact logging failed: %r", e)

    def save(self, task, val_metrics: dict) -> str:
        """Save a checkpoint at the current step (rank 0; the path, or ""
        on other ranks); with ``save_best``, also the best one when
        ``val_metrics`` improve on the monitored value. The file is written
        on a thread: ``join_pending_save`` waits for it."""
        monitored = val_metrics.get(self.monitor_key, val_metrics.get("total_loss", math.nan))
        better = (monitored < self.best_val if self.monitor_mode == "min"
                  else monitored > self.best_val)
        if better:
            self.best_val = monitored
        if not mesh.is_chief():
            return ""
        t0 = time.perf_counter()
        state = snapshot(task.state_dict())
        record = self._ckpt_writer.start(self.work_dir, self.global_step, state, keep=self.num_ckpt_keep,
                                         is_best=self.save_best and better,
                                         extra={"best_val": float(self.best_val)})
        record["hold_ms"] = (time.perf_counter() - t0) * 1e3
        self.saves.append(record)
        return record["path"]

    @torch.no_grad()
    def test(self, task) -> list:
        """The task's test loop from the newest checkpoint: per batch,
        ``task.after_test_step(i, host batch, host outputs)`` (or the host
        outputs themselves where the task has no such hook); then
        ``task.test_end``, if it has one. Returns the per-batch results.
        Under data parallelism rank 0 alone runs it, on whole batches, and
        the other ranks return [] at once."""
        if task.device != self.device:
            raise ValueError(f"task on {task.device}, trainer on {self.device}")
        if not mesh.is_chief():
            return []
        self._restore(task)
        if self.global_step == 0:
            log.warning("no checkpoint in %r: testing the initial weights", self.work_dir)
        outputs = []
        t = time.perf_counter()
        for i, batch in enumerate(task.test_batches()):
            gen = torch.Generator(device=self.device).manual_seed(self.seed + 1 + i)
            out = task.test_step(task.to_device(_host(batch)), gen)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            outputs.append(task.after_test_step(i, batch, out) if hasattr(task, "after_test_step")
                           else out)
        if hasattr(task, "test_end"):
            task.test_end(outputs)
        self.test_seconds = time.perf_counter() - t
        return outputs
