"""Port parity of gradient accumulation (``accumulate_grad_batches``) against
optax ``MultiSteps``, which the JAX task wraps around both optimizers.

- The rule: both optimizers fed identical gradients for 4 micro-steps at
  k = 2 give optax's params after every micro-step (atol 1e-6, the
  training slice's optimizer tolerance), with a schedule and lr that move
  them by ~1e-2, and the same update counts.
- Through the tasks: 4 micro-steps of the JAX task and of the port on the
  same weights and batches (gathered banks, dropout 0, noise and crop
  starts pinned), with ``disc_start_steps`` 1 inside the window, so the
  two accumulators fall out of phase, and the recipe's discriminator lr
  (1e-4). After micro-steps 2 and 4 the params agree at atol 1e-6 plus,
  per element, what a gradient difference at the gradient tolerance can
  move one Adam step: lr * tol_g / (sqrt(v_hat) + eps), at most 2 lr
  (``_adam_atol``). That term is ~1e-7 for an element whose gradient is
  well above the tolerance and reaches the lr only where the gradient is
  at round-off: the conv biases of the discriminator's instance-normed
  blocks (``win_*.conv_1/2.bias``), whose gradients the norm all but
  cancels (|g| ~ 1e-9 against 1e-2 in the rest of the tensor; the two
  packages disagree even on their sign) and which Adam's first step
  turns into a step of up to the lr (measured: 1.1e-6 to 1.1e-5 at lr
  1e-4, one element each of four biases; every other element within
  1e-6); after every micro-step the update counts and
  the micro-step counts are equal, the accumulated gradient means agree
  at the gradient tolerance of tests/test_torch_train_task.py (rtol 1e-3,
  atol 1e-6 of the largest), and so do Adam's first moments; a micro-step
  that does not complete the k leaves every param exactly as it was.
- The NaN skip through the tasks: 5 micro-steps of both tasks with a NaN
  in the mels of the second, the discriminator off. The JAX task keeps
  MultiSteps' state through ``_select_tree(finite, ...)``, as the port's
  device rule keeps its running mean and count (``optim.GradAccumulator``):
  after every micro-step the counts are equal and the means and params
  agree at the tolerances above. The JAX task's weights turn NaN at the
  NaN micro-step, the gated-off discriminator's too (its guard and its
  gate multiply NaN updates by 0: ROADMAP, JAX-side faults), so both sets
  are put back to their values before that step, which is what the guard
  and the gate mean to keep; its optimizer states are its own.
- The port's own rules: a NaN micro-step leaves the generator's
  accumulators, counters and params untouched, and reports the norm of
  the running mean it did not change; a resume from a checkpoint taken
  after an odd micro-step equals the uninterrupted run bit for bit, the
  micro-step count a device tensor in the checkpoint.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_train_task as T  # noqa: E402

from dicttts_tpu.models import discriminator as jdisc  # noqa: E402
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask  # noqa: E402
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params  # noqa: E402
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask  # noqa: E402
from dicttts_tpu_torch.train.trainer import Trainer  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

K = 2
U = np.array([0.3, 0.8, 0.45], np.float32)


def test_accumulation_rule_matches_optax_multisteps():
    cfg = dict(T.CFG, accumulate_grad_batches=K, warmup_updates=1, disc_lr=0.05)
    task = DictTTSTask(cfg, bank=T._bank(0), device="cpu")
    task.build_state(1)
    jt = JTask(cfg, None)
    assert isinstance(jt.tx_g, optax.MultiSteps) and isinstance(jt.tx_d, optax.MultiSteps)
    for name, module, opt, tx, norm_key, sched in (
            ("g", task.model, task.opt_g, jt.tx_g, "generator_grad_norm", task.schedule_g),
            ("d", task.disc, task.opt_d, jt.tx_d, "discriminator_grad_norm", task.schedule_d)):
        params = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
        jp = {n: jnp.asarray(v) for n, v in params.items()}
        opt_state = tx.init(jp)
        step = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
            *tx.update(g, st, p)))
        rng = np.random.RandomState(7)
        mean = None
        for i, scale in enumerate((3.0, 1e-4, 0.5, 2.0)):
            grads = {n: (rng.randn(*v.shape) * scale).astype(np.float32) for n, v in params.items()}
            jp, opt_state = step({n: jnp.asarray(g) for n, g in grads.items()}, opt_state, jp)
            for n, p in module.named_parameters():
                p.grad = torch.tensor(grads[n])
            norm = task._micro_step(name, opt, list(module.parameters()), task.cfg[norm_key], sched)
            # the update is tried at every micro-step on the running mean (optax's Welford rule)
            n = i % K
            mean = {k: g if n == 0 else (mean[k] + (g - mean[k]) / np.float32(n + 1)) for k, g in grads.items()}
            want = np.sqrt(sum(float(np.square(v.astype(np.float64)).sum()) for v in mean.values()))
            np.testing.assert_allclose(float(norm), want, rtol=1e-5)
            assert getattr(task, f"updates_{name}") == int(opt_state.gradient_step) == (i + 1) // K
            assert task.acc[name].n == int(opt_state.mini_step)
            for n, p in module.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), rtol=0, atol=1e-6,
                                           err_msg=f"{name} {n} after micro-step {i + 1}")
        moved = max(float(np.abs(np.asarray(jp[n]) - params[n]).max()) for n in params)
        assert moved > 1e-3


def _tree(module, flax_tree):
    """A flax-layout tree as the port's names (numpy)."""
    return jax_params_to_state(module, jax.device_get(flax_tree))


def _assert_grads_close(module, got: list, want: dict, what) -> float:
    """The gradient tolerance (rtol 1e-3, atol 1e-6 of the largest element);
    returns that largest element."""
    names = [n for n, _ in module.named_parameters()]
    top = max(np.abs(np.asarray(v)).max() for v in want.values())
    for n, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]), rtol=1e-3, atol=1e-6 * top,
                                   err_msg=f"{what} {n}")
    return float(top)


def _adam_atol(opt, p, top: float) -> np.ndarray:
    """Per element of ``p``: 1e-6, plus the most that a gradient difference
    at the gradient tolerance (1e-3 |g| + 1e-6 top, |g| read as sqrt(v_hat))
    moves the last Adam step of lr: lr * tol_g / (sqrt(v_hat) + eps), at
    most 2 lr (a step is at most lr either way)."""
    st, group = opt.state[p], opt.param_groups[0]
    lr, eps, b2 = float(group["lr"]), group["eps"], group["betas"][1]  # the lr is a device scalar
    g = (st["exp_avg_sq"] / (1 - b2 ** float(st["step"]))).sqrt().numpy()
    return 1e-6 + np.minimum(lr * (1e-3 * g + 1e-6 * top) / (g + eps), 2 * lr)


def test_accumulation_through_the_task_matches_the_jax_task(monkeypatch):
    cfg = dict(T.CFG, accumulate_grad_batches=K, disc_start_steps=1, disc_lr=1e-4)
    jt = JTask(dict(cfg), None)
    state = jt.build_state(jax.random.PRNGKey(0))
    params_g = T._randomize(state["params_g"], 2, 0.2)
    params_d = T._randomize(state["params_d"], 3, 0.05)
    state.update(params_g=params_g, params_d=params_d, opt_g=jt.tx_g.init(params_g),
                 opt_d=jt.tx_d.init(params_d))
    bank = T._bank(0)
    batches = [T._batch(s) for s in (1, 2, 3, 4)]
    rng = np.random.RandomState(4)
    eps = rng.randn(T.B, T.T // 4, T.CFG["latent_size"]).astype(np.float32)
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(eps, dtype) if tuple(shape) == eps.shape else normal(key, shape, dtype)))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U))
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", T._NoDropoutBlock)
    jstep = jax.jit(jt.train_step)

    task = DictTTSTask({**cfg, "disc_dropout": 0.0, "use_device_dict_bank": False}, device="cpu")
    task.build_state(0)
    load_jax_params(task.model, params_g)
    load_jax_params(task.disc, params_d)
    counts, top = [], {"g": 0.0, "d": 0.0}
    for i, batch in enumerate(batches):
        gathered = dict(batch, keys=bank["keys"][batch["word_tokens"]],
                        values=bank["keys"][batch["word_tokens"]],
                        **{k: bank[k][batch["word_tokens"]] for k in ("key_map", "pinyin", "pinyin_map")})
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in gathered.items()}, jax.random.PRNGKey(i))
        starts = torch.tensor(T._starts(U, batch["mel_lengths"]))
        tm = task.train_step(task.to_device(gathered), None, eps=torch.tensor(eps), start_frames_g=starts,
                             start_frames_d=starts)
        np.testing.assert_allclose(tm["total_loss"].item(), float(jm["total_loss"]), rtol=1e-5, atol=1e-6)
        for name, module, opt in (("g", task.model, task.opt_g), ("d", task.disc, task.opt_d)):
            js = state[f"opt_{name}"]
            assert getattr(task, f"updates_{name}") == int(js.gradient_step), (name, i)
            assert task.acc[name].n == int(js.mini_step), (name, i)
            top[name] = max(top[name], _assert_grads_close(
                module, task.acc[name].grads, _tree(module, js.acc_grads),
                f"acc_{name} after micro-step {i + 1}"))
            adam = js.inner_opt_state[1][0]
            if int(js.gradient_step):
                _assert_grads_close(module, [opt.state[p]["exp_avg"] for p in module.parameters()],
                                    _tree(module, adam.mu), f"mu_{name} after micro-step {i + 1}")
        counts.append((task.updates_g, task.updates_d, int(task.acc["g"].n), int(task.acc["d"].n)))
        if task.acc["g"].n:  # mid-accumulation: nothing moved
            assert all(torch.equal(before[n], p) for n, p in task.model.named_parameters())
        if i % 2:
            for name, module, opt in (("g", task.model, task.opt_g), ("d", task.disc, task.opt_d)):
                want = _tree(module, state[f"params_{name}"])
                for n, p in module.named_parameters():
                    err = np.abs(p.detach().numpy() - np.asarray(want[n]))
                    atol = _adam_atol(opt, p, top[name]) if opt.updates() else 1e-6
                    assert (err <= atol).all(), (n, i + 1, err.max(), err[err > atol])
    # the generator updates at micro-steps 2 and 4, the discriminator (on
    # from micro-step 2) at 3; its accumulator holds micro-step 4
    assert counts == [(0, 0, 1, 0), (1, 0, 0, 1), (1, 1, 1, 0), (2, 1, 0, 1)]


def test_a_nan_micro_step_leaves_the_accumulation_untouched():
    task = DictTTSTask({**T.CFG, "accumulate_grad_batches": 3, "disc_start_steps": 5},
                       bank=T._bank(0), device="cpu")
    task.build_state(3)
    task.train_step(task.to_device(T._batch(4)), torch.Generator().manual_seed(0))
    bad = T._batch(5)
    bad["mels"][0, 3, 5] = np.nan
    acc = [a.clone() for a in task.acc["g"].grads]
    params = [p.detach().clone() for p in task.model.parameters()]
    opt = task.opt_g.state_dict()
    assert task.acc["g"].n == 1 and any(bool(a.abs().sum()) for a in acc)
    metrics = task.train_step(task.to_device(bad), torch.Generator().manual_seed(1))
    # the norm reported is the running mean's, which the skipped micro-step left as it was
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(a) for a in acc]))
    assert not torch.isfinite(metrics["total_loss"]) and torch.equal(metrics["grad_norm_g"], norm)
    assert task.acc["g"].n == 1 and task.updates_g == 0 and task.step == 2
    assert all(torch.equal(a, b) for a, b in zip(acc, task.acc["g"].grads))
    assert all(torch.equal(a, b) for a, b in zip(params, task.model.parameters()))
    assert task.opt_g.state_dict() == opt
    task.train_step(task.to_device(T._batch(6)), torch.Generator().manual_seed(2))
    assert task.acc["g"].n == 2 and task.updates_g == 0
    task.train_step(task.to_device(T._batch(7)), torch.Generator().manual_seed(3))
    assert task.acc["g"].n == 0 and task.updates_g == 1


def test_the_nan_skip_under_accumulation_matches_the_jax_task(monkeypatch):
    cfg = dict(T.CFG, accumulate_grad_batches=K, disc_start_steps=100, lr=0.05, warmup_updates=1)
    jt = JTask(dict(cfg), None)
    state = jt.build_state(jax.random.PRNGKey(0))
    params_g = T._randomize(state["params_g"], 5, 0.2)
    state.update(params_g=params_g, opt_g=jt.tx_g.init(params_g))
    bank = T._bank(0)
    batches = [T._batch(s) for s in (11, 12, 13, 14, 15)]
    batches[1]["mels"][1, 20, 7] = np.nan
    rng = np.random.RandomState(6)
    eps = rng.randn(T.B, T.T // 4, T.CFG["latent_size"]).astype(np.float32)
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(eps, dtype) if tuple(shape) == eps.shape else normal(key, shape, dtype)))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U))
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", T._NoDropoutBlock)
    jstep = jax.jit(jt.train_step)

    task = DictTTSTask({**cfg, "disc_dropout": 0.0, "use_device_dict_bank": False}, device="cpu")
    task.build_state(0)
    load_jax_params(task.model, params_g)
    load_jax_params(task.disc, state["params_d"])
    top, counts = 0.0, []
    for i, batch in enumerate(batches):
        gathered = dict(batch, keys=bank["keys"][batch["word_tokens"]],
                        values=bank["keys"][batch["word_tokens"]],
                        **{k: bank[k][batch["word_tokens"]] for k in ("key_map", "pinyin", "pinyin_map")})
        before = {k: state[k] for k in ("params_g", "params_d")}
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in gathered.items()}, jax.random.PRNGKey(i))
        if not np.isfinite(float(jm["total_loss"])):
            state = dict(state, **before)  # what the JAX guard means to keep (its weights are NaN)
        starts = torch.tensor(T._starts(U, batch["mel_lengths"]))
        tm = task.train_step(task.to_device(gathered), None, eps=torch.tensor(eps), start_frames_g=starts,
                             start_frames_d=starts)
        assert np.isfinite(tm["total_loss"].item()) == np.isfinite(float(jm["total_loss"])) == (i != 1)
        if i != 1:
            np.testing.assert_allclose(tm["total_loss"].item(), float(jm["total_loss"]), rtol=1e-5, atol=1e-6)
        js = state["opt_g"]
        assert task.updates_g == int(js.gradient_step) and task.acc["g"].n == int(js.mini_step), i
        top = max(top, _assert_grads_close(task.model, task.acc["g"].grads, _tree(task.model, js.acc_grads),
                                           f"acc_g after micro-step {i + 1}"))
        want = _tree(task.model, state["params_g"])
        for n, p in task.model.named_parameters():
            err = np.abs(p.detach().numpy() - np.asarray(want[n]))
            atol = _adam_atol(task.opt_g, p, top) if task.updates_g else 1e-6
            assert (err <= atol).all(), (n, i + 1, err.max())
        counts.append((task.updates_g, int(task.acc["g"].n)))
    # the NaN micro-step (2) counts for nothing: the updates come at micro-steps 3 and 5
    assert counts == [(0, 1), (0, 1), (1, 0), (1, 1), (2, 0)] and task.updates_d == 0


@pytest.mark.parametrize("stop", [1, 3])
def test_resume_mid_accumulation_equals_the_uninterrupted_run(tmp_path, stop):
    """A resumed fit reads the given batches from their start again, so the
    list has ``stop`` batches: both runs see the same batch at each step."""
    bank = T._bank(0)
    batches = [T._batch(s) for s in (5, 6, 7)[:stop]]

    def run(work_dir, max_updates):
        task = DictTTSTask(dict(T.CFG, dropout=0.1, predictor_dropout=0.2, accumulate_grad_batches=K),
                           bank=bank, device="cpu")
        Trainer(str(work_dir), max_updates=max_updates, val_check_interval=1, num_sanity_val_steps=0,
                device="cpu").fit(task, batches)
        return task

    straight = run(tmp_path / "a", stop + 1)
    run(tmp_path / "b", stop)
    state = torch.load(os.path.join(tmp_path / "b", f"model_ckpt_steps_{stop}.ckpt"),
                       weights_only=True)["state"]
    assert state["acc_g"]["n"] == 1 and state["acc_d"]["n"] == 1  # saved mid-accumulation
    assert isinstance(state["acc_g"]["n"], torch.Tensor)  # the device count
    resumed = run(tmp_path / "b", stop + 1)
    assert (resumed.step, resumed.updates_g, resumed.updates_d) == (
        straight.step, straight.updates_g, straight.updates_d) == (stop + 1, (stop + 1) // K,
                                                                  (stop + 1) // K)
    for a, b in ((straight.model, resumed.model), (straight.disc, resumed.disc)):
        for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), n
    for name in ("g", "d"):
        assert straight.acc[name].n == resumed.acc[name].n
        assert all(torch.equal(x, y) for x, y in zip(straight.acc[name].grads, resumed.acc[name].grads))
