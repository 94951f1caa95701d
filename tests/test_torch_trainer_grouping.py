"""The port's trainer groups steps as the JAX trainer does
(``steps_per_dispatch``), on the CPU, where a group's steps run eagerly.

- the five cases of tests/test_trainer_grouping.py on a torch stub task:
  mixed shapes still validate and checkpoint, a group crossing the
  validation mark still validates, ``steady_per_step_s`` after several
  groups and None after one, and the per-step randomness unchanged by a
  resume at K = 1 and K = 2;
- the JAX ``Trainer`` and the port's on the same stub shape sequence at
  K = 3 and 4: the same checkpoint steps and the same (prefix, step) calls
  of ``log_metrics`` (``tb_log_interval`` 1, so every group's end shows);
  and the one difference, a re-queued batch at ``max_updates``;
- ``DictTTSTask`` at small widths, K = 1 against K = 4 over 8 mixed-shape
  steps across the discriminator's start: every step's losses and the final
  weights, Adam moments and counts equal bit for bit; the same with a
  non-finite loss inside a group, whose step leaves the state untouched;
- the device forms of the schedules against their host forms, and the
  masked AdamW's skip, bit for bit, and its one lr buffer, which a
  captured update may read at every replay; gloo refuses captured steps.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_train_task as T
from dicttts_tpu.parallel.mesh import make_mesh
from dicttts_tpu.train.trainer import Trainer as JTrainer
from dicttts_tpu.utils.checkpoint import get_all_ckpts as jax_ckpts
from dicttts_tpu_torch.parallel import mesh
from dicttts_tpu_torch.train.optim import MaskedAdamW
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.train.trainer import Trainer
from dicttts_tpu_torch.utils.checkpoint import bit_differences, get_all_ckpts
from dicttts_tpu_torch.utils.schedulers import rsqrt_schedule, step_decay_schedule

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)


class StubTask:
    """tests/test_trainer_grouping.py's stub in torch: state w (a scalar
    that counts the steps), loss = mean(batch's mels); one epoch is one
    batch of each shape, in order."""

    def __init__(self, shapes=((4, 8), (4, 16))):
        self.shapes = shapes
        self.device = torch.device("cpu")

    def build_state(self, seed):
        self.w = torch.zeros(())
        self.acc = torch.zeros(())
        self.step = 0

    def state_dict(self):
        return {"w": self.w, "acc": self.acc, "step": self.step}

    def load_state_dict(self, state):
        self.w, self.acc, self.step = state["w"].clone(), state["acc"].clone(), int(state["step"])

    def attach_device_frame_cache(self):
        pass

    def to_device(self, batch):
        return {k: torch.as_tensor(v) for k, v in batch.items()}

    def train_step(self, batch, generator):
        self.w = self.w + 1.0
        self.step += 1
        return {"total_loss": batch["mels"].mean()}

    def val_step(self, batch, generator):
        return {"total_loss": batch["mels"].mean()}

    def train_batches(self):
        for i, shape in enumerate(self.shapes):
            yield {"mels": np.full(shape, float(i), np.float32)}

    def val_batches(self):
        yield {"mels": np.ones((4, 8), np.float32)}


class RngAccTask(StubTask):
    """The step's generator draws into an accumulator, so the trainer's
    stream of draws shows in the checkpointed state."""

    def train_step(self, batch, generator):
        self.acc = self.acc + torch.randn((), generator=generator)
        return super().train_step(batch, generator)


def _trainer(work_dir, **kw):
    kw = {"val_check_interval": 4, "num_sanity_val_steps": 0, "device": "cpu", **kw}
    return Trainer(str(work_dir), **kw)


def _steps(work_dir):
    return sorted(int(p.split("_")[-1].split(".")[0]) for p in get_all_ckpts(str(work_dir)))


def test_mixed_shapes_still_validate_and_checkpoint(tmp_path):
    task = StubTask()
    _trainer(tmp_path / "exp", max_updates=8, log_interval=2, steps_per_dispatch=4).fit(task)
    assert task.step == 8 and float(task.w) == 8.0
    steps = _steps(tmp_path / "exp")
    assert 4 in steps and 8 in steps, steps  # both marks, though every group ends odd-shaped


def test_group_crossing_interval_still_validates(tmp_path):
    task = StubTask(shapes=((4, 8),) * 3)
    trainer = _trainer(tmp_path / "exp2", max_updates=9, steps_per_dispatch=3)
    trainer.fit(task)
    steps = _steps(tmp_path / "exp2")
    assert any(s <= 6 for s in steps) and 9 in steps, steps
    # groups end at K, at each mark (4, 8) and at max_updates
    assert [h["group_size"] for h in trainer.history] == [3, 3, 3, 1, 3, 3, 3, 1, 1]


def test_steady_state_throughput_recorded(tmp_path):
    trainer = _trainer(tmp_path / "exp3", max_updates=8, val_check_interval=100, steps_per_dispatch=2)
    trainer.fit(StubTask(shapes=((4, 8), (4, 8))))
    assert trainer.steady_per_step_s is not None and 0 < trainer.steady_per_step_s < 60.0
    assert [h["group"] for h in trainer.history] == [0, 0, 1, 1, 2, 2, 3, 3]


def test_steady_state_none_for_single_dispatch(tmp_path):
    trainer = _trainer(tmp_path / "exp4", max_updates=2, val_check_interval=100, steps_per_dispatch=2)
    trainer.fit(StubTask(shapes=((4, 8), (4, 8))))
    assert trainer.steady_per_step_s is None


@pytest.mark.parametrize("k", [1, 2])
def test_rng_stream_resume_stable(tmp_path, k):
    """Each step's draws are a function of (seed, step): 2 + 2 resumed steps
    equal 4 straight ones, at K = 1 and, resuming from a validation mark
    that ends a group, at K = 2."""
    shapes = ((4, 8),) * 4

    def run(work_dir, max_updates):
        task = RngAccTask(shapes)
        _trainer(work_dir, max_updates=max_updates, val_check_interval=2, seed=7,
                 steps_per_dispatch=k).fit(task)
        return task

    straight = run(tmp_path / "straight", 4)
    run(tmp_path / "resumed", 2)
    resumed = run(tmp_path / "resumed", 4)
    assert resumed.step == 4 and torch.equal(straight.acc, resumed.acc)


class JaxStub:
    """tests/test_trainer_grouping.py's StubTask, on a given shape sequence."""

    def __init__(self, shapes):
        self.shapes = shapes

    def build_state(self, rng):
        return {"w": jnp.zeros(()), "step": jnp.zeros((), jnp.int32)}

    def train_step(self, state, batch, rng):
        return {"w": state["w"] + 1.0, "step": state["step"] + 1}, {"total_loss": jnp.mean(batch["mels"])}

    def val_step(self, state, batch, rng):
        return {"total_loss": jnp.mean(batch["mels"])}

    def train_batches(self):
        for i, shape in enumerate(self.shapes):
            yield {"mels": np.full(shape, float(i), np.float32)}

    def val_batches(self):
        yield {"mels": np.ones((4, 8), np.float32)}


@pytest.mark.parametrize("k", [3, 4])
def test_groups_match_the_jax_trainer(tmp_path, k):
    shapes = ((4, 8), (4, 8), (4, 16), (4, 16), (4, 16), (4, 8), (4, 8), (4, 8), (4, 8), (4, 16), (4, 16))
    schedule = dict(max_updates=26, val_check_interval=5, num_sanity_val_steps=0, num_ckpt_keep=100,
                    steps_per_dispatch=k)
    calls = {"jax": [], "port": []}
    jt = JTrainer(str(tmp_path / "jax"), tb_log_interval=1, mesh=make_mesh(1), **schedule)
    jt.log_metrics = lambda metrics, prefix: calls["jax"].append((prefix, jt.global_step))
    jt.fit(JaxStub(shapes))
    pt = Trainer(str(tmp_path / "port"), log_interval=1, device="cpu", **schedule)
    pt.log_metrics = lambda metrics, prefix: calls["port"].append((prefix, pt.global_step))
    pt.fit(StubTask(shapes))

    def steps(paths):
        return sorted(int(p.split("_")[-1].split(".")[0]) for p in paths)

    assert steps(get_all_ckpts(str(tmp_path / "port"))) == steps(jax_ckpts(str(tmp_path / "jax")))
    # the JAX trainer validates once more after its last step, where the port's has just validated
    assert sorted(set(calls["port"])) == sorted(set(calls["jax"]))
    assert [c for c in calls["port"] if c[0] == "tr"] == [c for c in calls["jax"] if c[0] == "tr"]
    assert len({c for c in calls["port"] if c[0] == "tr"}) < 26  # the groups held several steps


def test_a_requeued_batch_at_max_updates_runs_alone(tmp_path):
    """The one difference from the JAX rule: the odd batch that a shape
    change re-queues at max_updates runs alone, where the JAX trainer joins
    it with the next batch of its shape and steps past max_updates."""
    shapes = ((4, 8), (4, 16), (4, 16))
    schedule = dict(max_updates=2, val_check_interval=100, num_sanity_val_steps=0, steps_per_dispatch=4)
    jt = JTrainer(str(tmp_path / "jax"), mesh=make_mesh(1), **schedule)
    assert int(jax.device_get(jt.fit(JaxStub(shapes))["step"])) == 3
    task = StubTask(shapes)
    Trainer(str(tmp_path / "port"), device="cpu", **schedule).fit(task)
    assert task.step == 2 and _steps(tmp_path / "port") == [2]


def _batches(n_frames, nan_at=None):
    """T's collater-format batches at the given frame widths (two shapes
    here); ``nan_at``: the index of a batch with a NaN in its mels."""
    out = []
    for i, t in enumerate(n_frames):
        b = T._batch(100 + i, lengths=(t, t - 30))
        b = {k: (v[:, :t] if k in ("mel2word", "mels") else v) for k, v in b.items()}
        if i == nan_at:
            b["mels"] = b["mels"].copy()
            b["mels"][0, 3, 5] = np.nan
        out.append(b)
    return out


def _fit_dict_tts(tmp_path, k, batches, tag):
    cfg = dict(T.CFG, dropout=0.1, predictor_dropout=0.2, disc_start_steps=3, disc_interval=2)
    task = DictTTSTask(cfg, bank=T._bank(0), device="cpu")
    losses = []
    step = task.train_step

    def recording(batch, generator=None, **kw):
        m = step(batch, generator, **kw)
        losses.append({k_: v.clone() for k_, v in m.items()})
        return m

    task.train_step = recording
    trainer = Trainer(str(tmp_path / tag), max_updates=len(batches), val_check_interval=100,
                      num_sanity_val_steps=0, log_interval=3, device="cpu", steps_per_dispatch=k)
    trainer.fit(task, batches, batches[:1])
    return task, trainer, losses


def _assert_bitwise(a: dict, b: dict):
    assert bit_differences(a, b) == []


@pytest.mark.parametrize("nan_at", [None, 5])
def test_dict_tts_groups_equal_single_steps(tmp_path, nan_at):
    """8 steps over two frame widths (groups [96 x2], [144 x3], ... at K = 4),
    the discriminator from step 3 on every second step: K = 4 equals K = 1
    in every step's losses and in every bit of the final state. With a NaN
    in batch 5 (inside a group), that step's update is skipped at both K."""
    batches = _batches((96, 96, 144, 144, 144, 144, 144, 96), nan_at)
    one, t1, l1 = _fit_dict_tts(tmp_path, 1, batches, "k1")
    four, t4, l4 = _fit_dict_tts(tmp_path, 4, batches, "k4")
    assert [h["group_size"] for h in t4.history] == [2, 2, 4, 4, 4, 4, 1, 1]
    assert [h["group_size"] for h in t1.history] == [1] * 8
    for i, (a, b) in enumerate(zip(l1, l4)):
        _assert_bitwise(a, b)
        assert math.isfinite(float(a["total_loss"])) == (i != nan_at), i
    _assert_bitwise(one.state_dict(), four.state_dict())
    assert one.step == four.step == 8 and four.updates_d == 2  # steps 4 and 6
    assert four.updates_g == (7 if nan_at is not None else 8)


def test_nan_step_keeps_the_state_inside_a_group(tmp_path):
    """The skipped step itself: the state after batch 5 (NaN) equals the
    state after batch 4, in K = 4's group."""
    batches = _batches((144,) * 6, nan_at=5)
    a, _, _ = _fit_dict_tts(tmp_path, 4, batches[:5], "five")
    b, _, la = _fit_dict_tts(tmp_path, 4, batches, "six")
    assert not math.isfinite(float(la[5]["total_loss"]))
    sa, sb = a.state_dict(), b.state_dict()
    assert sb.pop("step") == 6 and sa.pop("step") == 5
    _assert_bitwise(sa, sb)


def test_device_schedules_equal_the_host_ones():
    counts = torch.arange(0, 60000, 3, dtype=torch.float32)
    for sched in (rsqrt_schedule(1.0, 8000, 192), rsqrt_schedule(2.0, 4000, 256), rsqrt_schedule(1.0, 1, 16),
                  step_decay_schedule(1e-4, 40000, 0.5)):
        got = sched(counts)
        want = torch.tensor([sched(int(c)) for c in counts.tolist()], dtype=torch.float64)
        assert torch.equal(got, want)
        assert float(sched(torch.tensor(9000.0))) == sched(9000)


def test_masked_adamw_skip_keeps_every_bit():
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(5, 3)), torch.nn.Parameter(torch.tensor([0.0, -0.0, 1.0]))]
    opt = MaskedAdamW(params, lr=1e-2, betas=(0.9, 0.98), eps=1e-8, weight_decay=0.01)
    for p in params:
        p.grad = torch.randn_like(p)
    opt.update(torch.tensor(1e-2, dtype=torch.float64), torch.tensor(True))
    before = [p.detach().clone() for p in params], opt.state_dict()["state"][0]["exp_avg"].clone()
    for p in params:
        p.grad = torch.full_like(p, float("nan"))
    opt.update(torch.tensor(1e-2, dtype=torch.float64), torch.tensor(False))
    assert all(torch.equal(a.view(torch.int32), p.detach().view(torch.int32)) for a, p in zip(before[0], params))
    assert torch.equal(before[1], opt.state[params[0]]["exp_avg"]) and float(opt.count) == 1.0
    # a torch AdamW checkpoint loads into the flat state
    ref = torch.optim.AdamW([torch.nn.Parameter(p.detach().clone()) for p in params], lr=1e-2,
                            betas=(0.9, 0.98), eps=1e-8, weight_decay=0.01)
    for q in ref.param_groups[0]["params"]:
        q.grad = torch.ones_like(q)
    ref.step()
    opt.load_state_dict(ref.state_dict())
    assert float(opt.count) == 1.0 and torch.equal(opt.state[params[1]]["exp_avg_sq"],
                                                    ref.state[ref.param_groups[0]["params"][1]]["exp_avg_sq"])


def test_masked_adamw_keeps_its_lr_in_one_buffer():
    """The group's lr is one float64 tensor from the state's allocation on:
    an applied update writes its lr there, a skipped one leaves it, and a
    load_state_dict brings its own. A captured update reads and writes
    that one address at every replay, never a tensor a later assignment
    frees."""
    torch.manual_seed(1)
    params = [torch.nn.Parameter(torch.randn(4, 2))]
    opt = MaskedAdamW(params, lr=3e-3, betas=(0.9, 0.98), eps=1e-8, weight_decay=0.0)
    opt.init_state()
    buf = opt.param_groups[0]["lr"]
    assert buf.dtype == torch.float64 and float(buf) == 3e-3
    ptr = buf.data_ptr()
    params[0].grad = torch.ones_like(params[0])
    for lr, apply in ((1e-2, True), (5e-2, False), (2e-2, True), (7e-2, False)):
        opt.update(torch.tensor(lr, dtype=torch.float64), torch.tensor(apply))
        assert opt.param_groups[0]["lr"] is buf and buf.data_ptr() == ptr
    assert float(buf) == 2e-2 and float(opt.count) == 2.0  # the last applied update's
    opt.update(torch.tensor(4e-2, dtype=torch.float64))
    assert float(buf) == 4e-2 and buf.data_ptr() == ptr
    saved = opt.state_dict()
    saved["param_groups"][0]["lr"] = torch.tensor(8e-3, dtype=torch.float64)
    opt.load_state_dict(saved)
    assert float(opt.param_groups[0]["lr"]) == 8e-3 and float(opt.count) == 3.0


def test_gloo_refuses_captured_steps(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="gloo"):
            mesh.check_graph_capture("steps_per_dispatch=16")
    finally:
        dist.destroy_process_group()
    mesh.check_graph_capture("steps_per_dispatch=16")  # no process group: nothing to refuse
