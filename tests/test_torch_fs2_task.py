"""Port parity of the FastSpeech2 training task
(dicttts_tpu_torch.train.tasks.fs2) against the JAX task, on the CPU.

- the recipe: the port's task builds the JAX task's model from the port's
  datasets/biaobei/fs2.yaml (its fields equal the JAX recipe's);
- one step: every loss (the mel loss 'l1:0.5|ssim:0.5', pdur, uv, f0) and
  every parameter's gradient of ``_losses`` from the same weights and
  batch, rtol 1e-5 / atol 1e-6 on the losses (relative: the f0 loss is in
  Hz squared, ~1e4, as the JAX package learns it), gradients rtol 1e-3 /
  atol 1e-6 of the largest;
- four optimizer steps (clip by global norm, AdamW with beta2 0.98 and
  weight decay, the rsqrt schedule) against the JAX ``train_step`` and its
  optax state: each step's losses as above, the parameters after it to
  1e-6 plus, per element, what a gradient difference at the gradient
  tolerance moves an Adam step (as tests/test_torch_ps_flow.py);
- amp against the JAX task under amp, on six seeded inputs: on each, the
  port's amp-vs-f32 gap (the largest relative gap over the losses) within
  twice the JAX package's own gap on that input;
- the RNN entries (tacotron's BiGRU, the rnn decoder's BiLSTM): one
  step's losses (rtol 1e-4) and gradients, and four AdamW steps with
  weight decay, as above; the GRU's b_hr and b_hz and the LSTM's b_ih,
  which flax's cells lack, stay exactly 0;
- the refusal of ``use_device_frame_cache``.

Dropout is 0 on both sides (the pitch predictor's fixed 0.1, the JAX
module's default, set to 0 on both); the JAX side runs under ``jax.jit``.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.config import load_config as jload_config
from dicttts_tpu.models import fastspeech2 as jfs2
from dicttts_tpu.train.tasks.fs2 import FastSpeech2Task as JTask
from dicttts_tpu_torch.config import CONFIG_ROOT, load_config
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params
from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

JAX_ROOT = os.path.join(os.path.dirname(__file__), "..", "dicttts_tpu", "configs")
NV, B, TT, TM, M = 24, 2, 12, 48, 80
CFG = dict(n_vocab=NV, hidden_size=32, encoder_type="rel_fft", decoder_type="conv", enc_layers=1,
           dec_layers=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=5, num_heads=2, dropout=0.0,
           predictor_dropout=0.0, predictor_kernel=3, pitch_norm="standard",
           mel_loss="l1:0.5|ssim:0.5", lr=0.05, warmup_updates=1, weight_decay=0.01,
           clip_grad_norm=1.0)
LOSSES = ("l1", "ssim", "pdur", "uv", "f0")


class _NoDropoutPitchPredictor(jfs2.PitchPredictor):
    dropout_rate: float = 0.0


@pytest.fixture(autouse=True)
def no_pitch_dropout(monkeypatch):
    monkeypatch.setattr(jfs2, "PitchPredictor", _NoDropoutPitchPredictor)


def batch(seed):
    """Collater-format 'fs' batch: phones padded, mel2ph from random
    durations, mels zero past each row's frames, f0 in Hz interpolated
    through the unvoiced frames (uv 1) and zero on padding frames."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros((B, TT), np.int32)
    mel2ph = np.zeros((B, TM), np.int32)
    lengths = (TM, 31)
    for b, (n_ph, n_fr) in enumerate(zip((10, 6), lengths)):
        tokens[b, :n_ph] = rng.randint(1, NV, n_ph)
        cuts = np.sort(rng.choice(np.arange(1, n_fr), n_ph - 1, replace=False))
        mel2ph[b, :n_fr] = np.searchsorted(cuts, np.arange(n_fr), side="right") + 1
    real = mel2ph > 0
    mels = ((rng.randn(B, TM, M) * 0.6 - 3) * real[:, :, None]).astype(np.float32)
    uv = ((rng.rand(B, TM) < 0.3) | ~real).astype(np.float32)
    f0 = (rng.uniform(100, 300, (B, TM)) * real).astype(np.float32)
    return {"txt_tokens": tokens, "mel2ph": mel2ph, "mels": mels, "f0": f0, "uv": uv,
            "mel_lengths": np.array(lengths, np.int32)}


def jax_params(jt, seed):
    shapes = jax.eval_shape(lambda r: jt.build_state(r)["params_g"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.2).astype(np.float32), shapes)
    params["dur_predictor"]["out"]["bias"] = np.full((1,), 1.0, np.float32)
    return params


def ported(cfg, params):
    task = FastSpeech2Task(dict(cfg), device="cpu")
    task.build_state(0)
    load_jax_params(task.model, params)
    task.model.pitch_predictor.dropout_rate = 0.0
    return task


def test_recipe_builds_the_jax_tasks_model():
    name = os.path.join("datasets", "biaobei", "fs2.yaml")
    cfg = {**load_config(os.path.join(CONFIG_ROOT, name), save=False), "n_vocab": 60}
    jcfg = {**jload_config(os.path.join(JAX_ROOT, name), save=False), "n_vocab": 60}
    jt, task = JTask(jcfg, None), FastSpeech2Task(cfg, device="cpu")
    kw = task.model_kwargs()
    assert {k: getattr(jt.model, k) for k in kw} == kw
    assert (kw["encoder_type"], kw["decoder_type"], kw["hidden_size"], kw["pitch_norm"]) == (
        "rel_fft", "conv", 256, "standard")
    assert task.mel_loss_spec == jt.mel_loss_spec and task.infer_max_frames == jt.infer_max_frames
    assert task.schedule(500) == pytest.approx(float(rsqrt(jcfg)(500)), rel=1e-6)


def rsqrt(cfg):
    from dicttts_tpu.utils.schedulers import rsqrt_schedule

    return rsqrt_schedule(cfg["lr"], cfg["warmup_updates"], cfg["hidden_size"])


def _jax_losses(jt):
    def f(params, jb):
        loss, losses = jt._losses(params, jb, jax.random.PRNGKey(0), True)
        return loss, losses

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def test_losses_and_gradients_match_jax():
    jt = JTask(dict(CFG), None)
    params = jax_params(jt, 1)
    b = batch(2)
    (loss, losses), grads = _jax_losses(jt)(params, {k: jnp.asarray(v) for k, v in b.items()})
    task = ported(CFG, params)
    task.model.train()
    t_loss, t_losses, _ = task._losses(task.to_device(b))
    t_loss.backward()
    assert tuple(t_losses) == LOSSES and set(losses) == set(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(float(t_losses[k].detach()), float(losses[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), rtol=1e-5)
    assert float(losses["f0"]) > 1e3  # f0 in Hz: the loss is of the order of f0 squared
    ref = jax_params_to_state(task.model, jax.device_get(grads))
    named = dict(task.model.named_parameters())
    assert set(named) == set(ref)
    top = max(np.abs(np.asarray(g)).max() for g in ref.values())
    for name, g in ref.items():
        got = named[name].grad
        got = np.zeros_like(np.asarray(g)) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-3, atol=1e-6 * top, err_msg=name)


def _adam_atol(opt, p, top):
    st, group = opt.state[p], opt.param_groups[0]
    lr, eps, b2 = float(group["lr"]), group["eps"], group["betas"][1]  # the lr is a device scalar
    g = (st["exp_avg_sq"] / (1 - b2 ** float(st["step"]))).sqrt().numpy()
    return 1e-6 + np.minimum(lr * (1e-3 * g + 1e-6 * top) / (g + eps), 2 * lr)


def test_four_optimizer_steps_match_optax():
    jt = JTask(dict(CFG), None)
    params = jax_params(jt, 3)
    state = {"params_g": params, "opt_g": jt.tx.init(params), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jt.train_step)
    task = ported(CFG, params)
    top = 0.0
    for i in range(4):
        b = batch(10 + i)
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        tm = task.train_step(task.to_device(b))
        for k in (*LOSSES, "total_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=f"{k} @ {i}")
        top = max([top] + [float(p.grad.abs().max()) for p in task.model.parameters()])
        want = jax_params_to_state(task.model, jax.device_get(state["params_g"]))
        for n, p in task.model.named_parameters():
            err = np.abs(p.detach().numpy() - np.asarray(want[n]))
            assert (err <= _adam_atol(task.opt, p, top)).all(), (n, i, err.max())
    assert task.step == int(state["step"]) == 4
    assert task.opt.param_groups[0]["lr"] == task.schedule(3)


RNN_CFG = dict(CFG, encoder_type="tacotron", decoder_type="rnn")


def _flaxless_bias_slots(model):
    """The bias slots flax's cells lack: b_hr and b_hz of each GRU, b_ih of
    each LSTM, by parameter name."""
    slots = {}
    for n, m in model.named_modules():
        for s in ("", "_reverse"):
            if isinstance(m, torch.nn.GRU):
                slots[f"{n}.bias_hh_l0{s}"] = slice(0, 2 * m.hidden_size)
            elif isinstance(m, torch.nn.LSTM):
                slots[f"{n}.bias_ih_l0{s}"] = slice(None)
    return slots


def test_rnn_entries_gradients_and_adamw_steps_match_jax():
    """tacotron's CBHG (a BiGRU) with the rnn decoder (a BiLSTM): one step's
    losses and gradients against ``jax.grad``, then four AdamW steps with
    weight decay against optax, as above; the bias slots flax lacks get a
    zero gradient and stay exactly 0 through the steps. Losses rtol 1e-4
    (the recurrences compound the summation orders over 48 frames)."""
    jt = JTask(dict(RNN_CFG), None)
    params = jax_params(jt, 5)
    b = batch(6)
    (loss, losses), grads = _jax_losses(jt)(params, {k: jnp.asarray(v) for k, v in b.items()})
    task = ported(RNN_CFG, params)
    named = dict(task.model.named_parameters())
    slots = _flaxless_bias_slots(task.model)
    assert {n.split(".")[0] for n in slots} == {"encoder", "decoder"} and len(slots) == 4
    assert all(float(named[n].detach()[r].abs().max()) == 0 for n, r in slots.items())
    task.model.train()
    t_loss, t_losses, _ = task._losses(task.to_device(b))
    t_loss.backward()
    for k in LOSSES:
        np.testing.assert_allclose(float(t_losses[k].detach()), float(losses[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    ref = jax_params_to_state(task.model, jax.device_get(grads))
    assert set(named) == set(ref)
    top = max(np.abs(np.asarray(g)).max() for g in ref.values())
    for name, g in ref.items():
        np.testing.assert_allclose(named[name].grad.numpy(), np.asarray(g), rtol=1e-3, atol=1e-6 * top,
                                   err_msg=name)
    for n, r in slots.items():
        assert float(named[n].grad[r].abs().max()) == 0, n
        assert float(named[n].grad.abs().max()) > 0 or r == slice(None), n  # b_hn is trained

    state = {"params_g": params, "opt_g": jt.tx.init(params), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jt.train_step)
    task = ported(RNN_CFG, params)
    named = dict(task.model.named_parameters())
    assert task.opt.param_groups[0]["weight_decay"] == CFG["weight_decay"] > 0
    top = 0.0
    for i in range(4):
        b = batch(30 + i)
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        tm = task.train_step(task.to_device(b))
        for k in (*LOSSES, "total_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=f"{k} @ {i}")
        top = max([top] + [float(p.grad.abs().max()) for p in task.model.parameters()])
        want = jax_params_to_state(task.model, jax.device_get(state["params_g"]))
        for n, p in named.items():
            err = np.abs(p.detach().numpy() - np.asarray(want[n]))
            assert (err <= _adam_atol(task.opt, p, top)).all(), (n, i, err.max())
        for n, r in slots.items():
            assert float(named[n].detach()[r].abs().max()) == 0, (n, i)
    moved = max(float(np.abs(named[n].detach().numpy() - np.asarray(v)).max())
                for n, v in jax_params_to_state(task.model, params).items())
    assert moved > 1e-2


def _port_losses(task, b):
    task.model.train()
    _, losses, _ = task._losses(task.to_device(b))
    return np.array([float(losses[k].detach()) for k in LOSSES])


def test_amp_gap_within_twice_the_jax_gap_on_each_input():
    fns = {}
    for amp in (False, True):
        jt = JTask(dict(CFG, amp=amp), None)

        def losses(params, jb, jt=jt):
            from dicttts_tpu.ops.amp import amp_scope

            with amp_scope(jt.matmul_precision, jt.act_dtype):
                _, out = jt._losses(params, jb, jax.random.PRNGKey(0), True)
            return jnp.stack([out[k] for k in LOSSES])

        fns[amp] = jax.jit(losses)
    ratios = []
    for seed in range(2, 8):
        params, b = jax_params(JTask(dict(CFG), None), seed), batch(seed + 20)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jf, ja = (np.asarray(fns[a](params, jb)) for a in (False, True))
        pf = _port_losses(ported(CFG, params), b)
        pa = _port_losses(ported(dict(CFG, amp=True), params), b)
        np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-6)
        jax_gap = np.max(np.abs(ja - jf) / np.abs(jf))
        port_gap = np.max(np.abs(pa - pf) / np.abs(pf))
        assert jax_gap > 0
        ratios.append(port_gap / jax_gap)
    print("port gap / JAX gap per input:", np.round(ratios, 3))
    assert max(ratios) <= 2, ratios


def test_amp_keeps_the_state_f32_and_runs_the_encoder_in_bf16():
    params = jax_params(JTask(dict(CFG), None), 2)
    task = ported(dict(CFG, amp=True), params)
    dtypes = {}

    def record(name):
        def hook(module, args, out):
            dtypes.setdefault(name, out.dtype)
        return hook

    for name, m in task.model.named_modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
            m.register_forward_hook(record(name))
    m = task.train_step(task.to_device(batch(4)))
    assert np.isfinite(float(m["total_loss"]))
    assert dtypes["encoder.pre.conv_layers.0"] == torch.bfloat16
    assert {dtypes[k] for k in dtypes if not k.startswith("encoder.")} == {torch.float32}
    assert all(p.dtype == torch.float32 for p in task.model.parameters())
    assert all(v.dtype == torch.float32 for st in task.opt.state.values() for k, v in st.items()
               if k != "step")


def test_the_frame_cache_is_refused():
    with pytest.raises(ValueError, match="use_device_frame_cache"):
        FastSpeech2Task(dict(CFG, use_device_frame_cache=True), device="cpu")
    with pytest.raises(ValueError, match="use_device_frame_cache"):
        JTask(dict(CFG, use_device_frame_cache=True), None)


def _roundtrip(state):
    """``state`` through torch.save and torch.load, as a checkpoint."""
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=True)


def test_a_torch_adamw_checkpoint_loads():
    """A checkpoint written while the task stepped ``torch.optim.AdamW``
    (before it moved to MaskedAdamW) loads: the moments, the count and the
    lr come through, and the next update equals AdamW's next step."""
    task = FastSpeech2Task(dict(CFG), device="cpu")
    task.build_state(0)
    params = list(task.model.parameters())
    adamw = torch.optim.AdamW(params, lr=0.01, eps=1e-8, betas=(0.9, 0.98), weight_decay=CFG["weight_decay"])
    gen = torch.Generator().manual_seed(5)
    grads = [[torch.randn(p.shape, generator=gen) * 0.1 for p in params] for _ in range(3)]
    for gs in grads[:2]:
        for p, g in zip(params, gs):
            p.grad = g.clone()
        adamw.step()
    loaded = FastSpeech2Task(dict(CFG), device="cpu")
    loaded.build_state(1)
    loaded.load_state_dict(_roundtrip({"params_g": task.model.state_dict(), "opt_g": adamw.state_dict(),
                                       "step": 2}))
    assert loaded.opt.updates() == 2 and float(loaded.opt.param_groups[0]["lr"]) == 0.01
    for p, q in zip(params, loaded.model.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(adamw.state[p][k], loaded.opt.state[q][k]), k
    for p, q, g in zip(params, loaded.model.parameters(), grads[2]):
        p.grad, q.grad = g.clone(), g.clone()
    adamw.step()
    loaded.opt.update(0.01)
    for p, q in zip(params, loaded.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=0, atol=1e-6)
    assert loaded.opt.updates() == 3
