"""The trainer's checkpoint write on a thread beside the next steps
(``utils/checkpoint.CheckpointWriter``, ``Trainer.save``), on the CPU.

- a checkpoint saved at step s while the next steps run (its write held
  back until two more steps have updated the weights in place) loads equal,
  bit for bit, to a deep copy of the state taken at s;
- a pending write is joined before the next save, at the end of ``fit``,
  before ``test`` and before a resume reads the directory;
- a ``.part`` file is never taken for the newest checkpoint, and a write
  that fails leaves the last good one and raises at the join.
"""

import copy
import os
import threading

import pytest
import torch

import test_torch_train_task as T
import test_torch_trainer_grouping as G
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.train.trainer import Trainer
from dicttts_tpu_torch.utils import checkpoint as C

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

WAIT_S = 60  # a held write that is never released fails the test instead of hanging it


def _task():
    return DictTTSTask(dict(T.CFG, dropout=0.1, predictor_dropout=0.2), bank=T._bank(0), device="cpu")


class HeldWrites:
    """Holds each background write until ``release``, and logs when writes
    start and end."""

    def __init__(self, monkeypatch):
        self.events = []
        self.gate = threading.Event()
        write = C.save_checkpoint

        def held(work_dir, step, state, **kw):
            self.events.append(("start", step))
            assert self.gate.wait(WAIT_S), "a held write was never released"
            out = write(work_dir, step, state, **kw)
            self.events.append(("end", step))
            return out

        monkeypatch.setattr(C, "save_checkpoint", held)

    def release(self):
        self.gate.set()


def test_background_checkpoint_equals_the_state_at_its_step(tmp_path, monkeypatch):
    held = HeldWrites(monkeypatch)
    task = _task()
    trainer = Trainer(str(tmp_path), max_updates=6, val_check_interval=3, num_sanity_val_steps=0,
                      device="cpu", steps_per_dispatch=2)
    copies, steps_after = {}, []
    save, step = trainer.save, task.train_step

    def saving(task_, val_metrics):
        copies[trainer.global_step] = copy.deepcopy(task_.state_dict())
        return save(task_, val_metrics)

    def stepping(batch, generator=None, **kw):
        out = step(batch, generator, **kw)
        if copies:
            steps_after.append(task.step)
            if len(steps_after) == 2:  # two steps moved the weights in place: let the write go
                held.release()
        return out

    trainer.save, task.train_step = saving, stepping
    batches = [T._batch(s) for s in (1, 2, 3)]
    trainer.fit(task, batches, batches[:1])
    assert steps_after[:2] == [4, 5] and sorted(copies) == [3, 6]
    assert held.events.index(("end", 3)) < held.events.index(("start", 6))  # joined before the next save
    for s in (3, 6):
        step_, state = C.load_checkpoint(C.checkpoint_path(str(tmp_path), s))
        assert step_ == s
        G._assert_bitwise(state, copies[s])
    moved = [n for n, p in copies[3]["params_g"].items() if not torch.equal(p, copies[6]["params_g"][n])]
    assert moved  # the steps after the save updated the weights in place
    assert len(trainer.saves) == 2 and all(r["write_s"] > 0 and r["hold_ms"] >= 0 for r in trainer.saves)


def test_fit_returns_after_its_last_write(tmp_path, monkeypatch):
    held = HeldWrites(monkeypatch)
    trainer = Trainer(str(tmp_path), max_updates=2, val_check_interval=100, num_sanity_val_steps=0,
                      device="cpu")
    threading.Timer(0.5, held.release).start()
    batches = [T._batch(s) for s in (1, 2)]
    trainer.fit(_task(), batches, batches[:1])
    assert held.events == [("start", 2), ("end", 2)]
    assert C.get_last_checkpoint(str(tmp_path)) == C.checkpoint_path(str(tmp_path), 2)


def _pending_save_at(tmp_path, monkeypatch, steps=2):
    """A trainer whose fit wrote step ``steps - 1``'s checkpoint, then a
    save at ``steps`` whose write is held: (trainer, task, held)."""
    trainer = Trainer(str(tmp_path), max_updates=steps - 1, val_check_interval=100, num_sanity_val_steps=0,
                      device="cpu")
    task = _task()
    batches = [T._batch(s) for s in range(steps)]
    trainer.fit(task, batches, batches[:1])
    held = HeldWrites(monkeypatch)
    task.train_step(task.to_device(batches[-1]), trainer.step_generator(steps - 1))
    trainer.global_step = steps
    trainer.save(task, {"total_loss": 1.0})
    threading.Timer(0.5, held.release).start()
    return trainer, task, held


def test_test_joins_the_pending_write(tmp_path, monkeypatch):
    trainer, task, held = _pending_save_at(tmp_path, monkeypatch)
    task.test_batches = lambda: iter(())
    trainer.test(task)
    assert held.events == [("start", 2), ("end", 2)] and trainer.global_step == 2  # restored from step 2


def test_resume_joins_the_pending_write(tmp_path, monkeypatch):
    trainer, task, held = _pending_save_at(tmp_path, monkeypatch)
    trainer.max_updates = 3
    batches = [T._batch(s) for s in (7, 8)]
    trainer.fit(task, batches, batches[:1])
    assert held.events[:2] == [("start", 2), ("end", 2)]
    assert [h["step"] for h in trainer.history[-1:]] == [3] and task.step == 3  # resumed at 2


def test_part_files_are_never_the_newest(tmp_path):
    task = _task()
    task.build_state(0)
    C.save_checkpoint(str(tmp_path), 4, task.state_dict())
    open(os.path.join(tmp_path, "model_ckpt_steps_9.ckpt.part"), "wb").write(b"torn")
    assert C.get_last_checkpoint(str(tmp_path)) == C.checkpoint_path(str(tmp_path), 4)
    assert [os.path.basename(p) for p in C.get_all_ckpts(str(tmp_path))] == ["model_ckpt_steps_4.ckpt"]


def test_a_failed_write_raises_at_the_join_and_keeps_the_last_checkpoint(tmp_path, monkeypatch):
    task = _task()
    task.build_state(0)
    writer = C.CheckpointWriter()
    writer.start(str(tmp_path), 4, C.snapshot(task.state_dict()))
    writer.join()

    def torn(obj, path, *a, **kw):
        open(path, "wb").write(b"torn")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    writer.start(str(tmp_path), 5, C.snapshot(task.state_dict()))
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        writer.join()
    assert os.path.exists(os.path.join(tmp_path, "model_ckpt_steps_5.ckpt.part"))
    assert C.get_last_checkpoint(str(tmp_path)) == C.checkpoint_path(str(tmp_path), 4)
    writer.join()  # the error was raised once
