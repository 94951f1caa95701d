"""The two-stage post-glow training of PortaSpeechFlowTask
(dicttts_tpu_torch.train.tasks.ps_flow) against the JAX task's partitioned
optax update, with post_glow_training_start 2: four steps across the
switch from the same state, batches and noise.

Checked: each step's losses against the JAX step's (rtol 1e-5 / atol
1e-6); the parameters after each step against the JAX step's, to 1e-6
plus, per element, the most that a gradient difference at the gradient
tolerance (1e-3 |g| + 1e-6 of the largest) moves an Adam step
(lr * tol_g / (sqrt(v_hat) + eps), at most 2 lr; as
tests/test_torch_accumulate.py); the main parameters bit for bit unchanged
from the switch on and the Glow's before it; each optimizer's update count
(2 and 2) and the JAX schedules' counts; the Glow's schedule starting from
0 at the switch; a resume across the switch (a checkpoint after step 3)
equal to the unbroken run bit for bit; a non-finite loss in stage 2
skipping the update; and without two_stage, two steps of the one
optimizer over the whole model against the JAX parent step. The JAX step runs under ``jax.jit``, compiled once
for the four steps (the pinned noise is an argument of the traced step).

Two-stage training with ``accumulate_grad_batches`` = 2: four stage-one
micro-steps against the JAX task, whose main optimizer is MultiSteps-wrapped
(losses, parameters at the tolerance above, update and micro-step counts);
in stage two, two micro-steps equal one update of the Glow's optimizer
with their mean gradient (the JAX task steps its Glow optimizer at every
micro-step instead: ROADMAP, JAX-side faults).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_ps_task as P  # noqa: E402

from dicttts_tpu.train.tasks.ps_flow import PortaSpeechFlowTask as JFlow  # noqa: E402
from dicttts_tpu_torch.convert import jax_params_to_state  # noqa: E402
from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask  # noqa: E402
from dicttts_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

START = 2
CFG = dict(P.FLOW, post_glow_training_start=START, warmup_updates=1, lr=0.05, post_glow_lr=0.02)
BATCHES = [P.batch(s, lengths) for s, lengths in ((11, (P.T, 70)), (12, (80, P.T)),
                                                   (13, (P.T, 60)), (14, (90, 84)))]
NOISE = [P.eps(20 + i) for i in range(4)]


def _counts(opt_state):
    """Every ``count`` leaf of an optax state (adam's and the schedule's)."""
    flat = jax.tree_util.tree_flatten_with_path(opt_state)[0]
    return sorted({int(v) for path, v in flat if "count" in jax.tree_util.keystr(path)})


def _adam_atol(opt, p, top):
    st, group = opt.state[p], opt.param_groups[0]
    lr, eps, b2 = float(group["lr"]), group["eps"], group["betas"][1]  # the lr is a device scalar
    g = (st["exp_avg_sq"] / (1 - b2 ** float(st["step"]))).sqrt().numpy()
    return 1e-6 + np.minimum(lr * (1e-3 * g + 1e-6 * top) / (g + eps), 2 * lr)


def _run_port(params_g, params_d, steps, task=None):
    task = task or P.ported(PortaSpeechFlowTask, CFG, params_g, params_d)
    out = []
    for i in steps:
        m = task.train_step(task.to_device(BATCHES[i]), None, eps=torch.tensor(NOISE[i]))
        out.append(({k: float(v) for k, v in m.items()},
                    {n: p.detach().clone() for n, p in task.model.named_parameters()}))
    return task, out


def test_two_stage_steps_match_the_jax_partitioned_update(monkeypatch):
    jt = JFlow(dict(CFG), None)
    params_g, params_d = P.jax_state(jt, 3)
    state = {"params_g": params_g, "params_d": params_d, "opt_g": jt.tx_main.init(params_g),
             "opt_pf": jt.tx_pf.init(params_g), "opt_d": jt.tx_d.init(params_d),
             "step": jnp.zeros((), jnp.int32)}
    cur = {}
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        cur["noise"].astype(dtype) if tuple(shape) == NOISE[0].shape else normal(key, shape, dtype)))

    def step_with_noise(st, b, key, noise):  # the noise reaches the traced step as an argument
        cur["noise"] = noise
        return jt._train_step_inner(st, b, key)

    jstep = jax.jit(step_with_noise)
    task = P.ported(PortaSpeechFlowTask, CFG, params_g, params_d)
    main, post = task.partition()
    top = {"g": 0.0, "pf": 0.0}
    before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    for i in range(4):
        jb = {k: jnp.asarray(v) for k, v in BATCHES[i].items()}
        state, jm = jstep(state, jb, jax.random.PRNGKey(i), jnp.asarray(NOISE[i]))
        tm = task.train_step(task.to_device(BATCHES[i]), None, eps=torch.tensor(NOISE[i]))
        assert float(tm["post_stage"]) == float(jm["post_stage"]) == float(i >= START)
        for key in ("kl", "ssim", "l1", "wdur", "postflow", "total_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} @ {i}")
        stage = "pf" if i >= START else "g"
        grads = [p.grad for p in (post if i >= START else main) if p.grad is not None]
        top[stage] = max([top[stage]] + [float(g.abs().max()) for g in grads])
        want = jax_params_to_state(task.model, jax.device_get(state["params_g"]))
        for n, p in task.model.named_parameters():
            opt, t = (task.opt_pf, top["pf"]) if n.startswith("post_flow.") else (task.opt_g, top["g"])
            err = np.abs(p.detach().numpy() - np.asarray(want[n]))
            atol = _adam_atol(opt, p, t) if opt.updates() else 1e-6
            assert (err <= atol).all(), (n, i, err.max())
        # the frozen partition does not move at all; the active one does
        moved = {n for n, p in task.model.named_parameters() if not torch.equal(before[n], p)}
        assert moved and all(n.startswith("post_flow.") == (i >= START) for n in moved), (i, moved)
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    assert (task.updates_g, task.updates_pf, task.step) == (2, 2, 4)
    assert _counts(state["opt_g"]) == [2] and _counts(state["opt_pf"]) == [2]
    # the Glow's schedule read counts 0 and 1: its last lr is schedule_pf(1), not at the global step
    assert task.opt_pf.param_groups[0]["lr"] == task.schedule_pf(1) != task.schedule_pf(3)
    assert task.opt_g.param_groups[0]["lr"] == task.schedule_g(1)
    assert len(main) + len(post) == len(list(task.model.parameters())) and post and main


def test_resume_across_the_switch_equals_the_unbroken_run(tmp_path):
    params_g, params_d = P.jax_state(JFlow(dict(CFG), None), 4)
    _, straight = _run_port(params_g, params_d, range(4))
    task, _ = _run_port(params_g, params_d, range(3))
    path = save_checkpoint(str(tmp_path), 3, task.state_dict())
    resumed = P.ported(PortaSpeechFlowTask, CFG, params_g, params_d)
    step, state = load_checkpoint(path)
    resumed.load_state_dict(state)
    assert step == 3 and (resumed.updates_g, resumed.updates_pf) == (2, 1)
    _, after = _run_port(params_g, params_d, [3], resumed)
    assert after[0][0] == straight[3][0]
    for n, p in straight[3][1].items():
        assert torch.equal(p, after[0][1][n]), n


def test_a_non_finite_stage_two_loss_skips_the_update():
    params_g, params_d = P.jax_state(JFlow(dict(CFG), None), 5)
    task, _ = _run_port(params_g, params_d, range(START))
    bad = dict(BATCHES[2], mels=BATCHES[2]["mels"].copy())
    bad["mels"][0, 3, 5] = np.nan
    params = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    opt = task.opt_pf.state_dict()
    m = task.train_step(task.to_device(bad), None, eps=torch.tensor(NOISE[2]))
    # the skip is decided on the card: the step reports the norm it did not apply
    assert not np.isfinite(float(m["total_loss"])) and not np.isfinite(float(m["grad_norm_pf"]))
    assert task.updates_pf == 0 and task.step == START + 1
    assert all(torch.equal(params[n], p) for n, p in task.model.named_parameters())
    # the Glow's optimizer state, allocated when the task built it, is untouched
    after = task.opt_pf.state_dict()
    assert after["param_groups"] == opt["param_groups"]
    assert all(float(st["step"]) == 0 and not st["exp_avg"].any() and not st["exp_avg_sq"].any()
               for st in after["state"].values())


def test_joint_mode_trains_main_and_post_flow_under_one_optimizer(monkeypatch):
    """two_stage false: one optimizer over the whole model, the NLL added
    to the main losses (the JAX parent step); two steps against it."""
    cfg = dict(CFG, two_stage=False)
    jt = JFlow(dict(cfg), None)
    params_g, params_d = P.jax_state(jt, 6)
    state = {"params_g": params_g, "params_d": params_d, "opt_g": jt.tx_g.init(params_g),
             "opt_d": jt.tx_d.init(params_d), "step": jnp.zeros((), jnp.int32)}
    P.pin_jax(monkeypatch, NOISE[0])
    jstep = jax.jit(jt._train_step_inner)
    task = P.ported(PortaSpeechFlowTask, cfg, params_g, params_d)
    assert not task.staged and not hasattr(task, "opt_pf")
    top = 0.0
    for i in range(2):
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in BATCHES[i].items()},
                          jax.random.PRNGKey(i))
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
        tm = task.train_step(task.to_device(BATCHES[i]), None, eps=torch.tensor(NOISE[0]),
                             start_frames_g=P.starts(BATCHES[i]["mel_lengths"]),
                             start_frames_d=P.starts(BATCHES[i]["mel_lengths"]))
        for key in ("kl", "wdur", "postflow", "total_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} @ {i}")
        top = max([top] + [float(p.grad.abs().max()) for p in task.model.parameters()
                           if p.grad is not None])
        want = jax_params_to_state(task.model, jax.device_get(state["params_g"]))
        for n, p in task.model.named_parameters():
            err = np.abs(p.detach().numpy() - np.asarray(want[n]))
            atol = _adam_atol(task.opt_g, p, top) if p in task.opt_g.state else 1e-6
            assert (err <= atol).all(), (n, i, err.max())
        moved = {n for n, p in task.model.named_parameters() if not torch.equal(before[n], p)}
        assert any(n.startswith("post_flow.") for n in moved) and any(
            not n.startswith("post_flow.") for n in moved)
    assert task.updates_g == 2 and task.updates_d == 0


def _multisteps_counts(opt_state) -> tuple:
    """(gradient_step, mini_step) of the MultiSteps state inside an optax state."""
    flat = jax.tree_util.tree_flatten_with_path(opt_state)[0]
    pick = lambda name: [int(v) for path, v in flat if jax.tree_util.keystr(path).endswith(name)]  # noqa: E731
    (updates,), (micro,) = pick("gradient_step"), pick("mini_step")
    return updates, micro


ACC_CFG = dict(CFG, accumulate_grad_batches=2, post_glow_training_start=4)


def test_two_stage_accumulation_stage_one_matches_the_jax_task(monkeypatch):
    jt = JFlow(dict(ACC_CFG), None)
    params_g, params_d = P.jax_state(jt, 7)
    state = {"params_g": params_g, "params_d": params_d, "opt_g": jt.tx_main.init(params_g),
             "opt_pf": jt.tx_pf.init(params_g), "opt_d": jt.tx_d.init(params_d),
             "step": jnp.zeros((), jnp.int32)}
    cur = {}
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        cur["noise"].astype(dtype) if tuple(shape) == NOISE[0].shape else normal(key, shape, dtype)))

    def step_with_noise(st, b, key, noise):
        cur["noise"] = noise
        return jt._train_step_inner(st, b, key)

    jstep = jax.jit(step_with_noise)
    task = P.ported(PortaSpeechFlowTask, ACC_CFG, params_g, params_d)
    assert task.staged and set(task.acc) == {"g", "pf"}
    top, counts = 0.0, []
    for i in range(4):
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in BATCHES[i].items()}, jax.random.PRNGKey(i),
                          jnp.asarray(NOISE[i]))
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
        tm = task.train_step(task.to_device(BATCHES[i]), None, eps=torch.tensor(NOISE[i]))
        for key in ("kl", "ssim", "l1", "wdur", "postflow", "total_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} @ {i}")
        top = max([top] + [float(p.grad.abs().max()) for p in task.partition()[0]])
        assert (task.updates_g, int(task.acc["g"].n)) == _multisteps_counts(state["opt_g"]), i
        want = jax_params_to_state(task.model, jax.device_get(state["params_g"]))
        for n, p in task.model.named_parameters():
            err = np.abs(p.detach().numpy() - np.asarray(want[n]))
            atol = _adam_atol(task.opt_g, p, top) if task.updates_g and not n.startswith("post_flow.") else 1e-6
            assert (err <= atol).all(), (n, i, err.max())
        if i % 2 == 0:  # mid-accumulation: nothing moved
            assert all(torch.equal(before[n], p) for n, p in task.model.named_parameters())
        counts.append((task.updates_g, int(task.acc["g"].n), task.updates_pf))
    assert counts == [(0, 1, 0), (1, 0, 0), (1, 1, 0), (2, 0, 0)]


def test_two_stage_accumulation_stage_two_is_one_update_of_the_mean_gradient():
    """From the switch, two Glow micro-steps at k = 2 against one update of
    a k = 1 task from the same state with the two gradients' mean."""
    params_g, params_d = P.jax_state(JFlow(dict(ACC_CFG), None), 8)
    acc = P.ported(PortaSpeechFlowTask, dict(ACC_CFG, post_glow_training_start=0), params_g, params_d)
    one = P.ported(PortaSpeechFlowTask, dict(CFG, post_glow_training_start=0), params_g, params_d)
    _, post = one.partition()
    grads = []
    for i in (0, 1):  # each micro-step's Glow gradient at the switch's weights
        one.model.train()
        one.model.zero_grad(set_to_none=True)
        batch = one.to_device(BATCHES[i])
        with one.amp():
            out = one._forward(batch, None, torch.tensor(NOISE[i]))
        out["postflow"].backward()
        grads.append([p.grad.clone() if p.grad is not None else torch.zeros_like(p) for p in post])
        m = acc.train_step(acc.to_device(BATCHES[i]), None, eps=torch.tensor(NOISE[i]))
        np.testing.assert_allclose(float(m["total_loss"]), float(out["postflow"].detach()), rtol=1e-6)
        assert (acc.updates_pf, int(acc.acc["pf"].n)) == ((0, 1) if i == 0 else (1, 0))
    for p, g0, g1 in zip(post, *grads):
        p.grad = (g0 + g1) / 2
    one._micro_step("pf", one.opt_pf, post, one.cfg["generator_grad_norm"], one.schedule_pf)
    top = max(float(g.abs().max()) for g in grads[0] + grads[1])
    want = dict(one.model.named_parameters())
    for n, p in acc.model.named_parameters():
        err = np.abs(p.detach().numpy() - want[n].detach().numpy())
        atol = _adam_atol(acc.opt_pf, p, top) if n.startswith("post_flow.") else 0.0
        assert (err <= atol).all(), (n, err.max())
    assert acc.updates_pf == one.updates_pf == 1 and acc.updates_g == 0
    assert torch.equal(acc.opt_pf.count, one.opt_pf.count)
