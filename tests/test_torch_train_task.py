"""Port parity of the Dict-TTS GAN training step (dicttts_tpu_torch.train)
against the JAX task, and its bookkeeping: the recipe's hyperparameters,
the generator and discriminator losses and every gradient leaf from the
same state, the optimizer rule against optax, discriminator gating, the
NaN skip, and the trainer's checkpoints and resume.

The JAX task runs on gathered banks (``DictTTSTask(cfg, None)``, the eager
S2PA branch, as tests/test_device_bank.py builds it); the port runs on the
un-gathered bank through K1/K2's plain versions. Dropout is 0 on both
sides (the discriminator's hard-coded 0.25 is replaced on the JAX side),
and the posterior noise and the crop starts are pinned: the JAX draws are
replaced by numpy arrays, the port is given the same values.

Tolerances: losses rtol 1e-5 / atol 1e-6; gradients rtol 1e-3 / atol 1e-6
of the largest gradient of their parameter set (f32 on the CPU through the
whole generator and back; summation orders differ, and many leaves are
small sums of large terms); optimizer params atol 1e-6 (the rules are the
same, the operation order differs, and the steps move params by ~1e-2).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dicttts_tpu.config import load_config
from dicttts_tpu.models import discriminator as jdisc
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.serve import DictTTSServer, Request
from dicttts_tpu_torch.train.tasks import dict_tts as tdict
from dicttts_tpu_torch.train.tasks.adv_base import optimizer_step
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.train.trainer import Trainer
from dicttts_tpu_torch.utils.checkpoint import get_all_ckpts

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

RECIPE = os.path.join(os.path.dirname(__file__), "..", "dicttts_tpu", "configs", "tts", "dict_tts.yaml")
V, L, E, P, M = 40, 12, 32, 6, 80
B, TW, T = 2, 8, 144
CFG = dict(word_size=V, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dropout=0.0,
           predictor_dropout=0.0, value_embedding_size=30, dict_embed_dim=E,
           dur_predictor_layers=2, dur_predictor_kernel=3, latent_size=4, fvae_enc_dec_hidden=16,
           fvae_kernel_size=3, fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8,
           glow_kernel_size=3, prior_glow_n_blocks=1, mel_disc_hidden_size=8)


def test_recipe_defaults_match_the_jax_recipe():
    recipe = load_config(RECIPE)
    for key, value in tdict.DEFAULTS.items():
        assert recipe[key] == value, key
    assert jdisc.Disc2DBlockStack.dropout == tdict.DISC_DROPOUT
    jt = JTask(recipe, None)  # the JAX task's effective model settings
    task = DictTTSTask(device="cpu")
    model = task.build_model()
    assert model.predictor_grad == jt.model.predictor_grad
    assert model.dict_encoder.S2PA_module.s2pa_attention.dropout_rate == jt.model.dropout
    assert model.dur_predictor.dropout_rate == jt.model.predictor_dropout
    assert model.fvae.stride == jt.model.fvae_strides
    assert task.lambda_adv == jt.lambda_adv and task.disc_interval == jt.disc_interval
    assert task.disc_start_steps == jt.disc_start_steps


def _bank(seed):
    rng = np.random.RandomState(seed)
    km = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    km[4] = 0  # an all-masked word; its slot is padding below
    return {"keys": (rng.randn(V, L, E) * 0.5).astype(np.float32), "key_map": km,
            "pinyin": rng.randint(1, 30, (V, P)).astype(np.int32),
            "pinyin_map": np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1))}


def _batch(seed, lengths=(T, 100)):
    """Collater-format batch: BOS + words of 8-20 frames, mels zero past
    each row's length."""
    rng = np.random.RandomState(seed)
    wt = np.zeros((B, TW), np.int32)
    m2w = np.zeros((B, T), np.int32)
    wl = np.zeros(B, np.int32)
    for b, n_frames in enumerate(lengths):
        f, w = 0, 0
        while f < n_frames and w < TW:
            d = min(rng.randint(8, 21), n_frames - f)
            m2w[b, f:f + d] = w + 1
            f, w = f + d, w + 1
        wt[b, :w] = rng.randint(5, V, w)
        wt[b, 0] = 1
        wl[b] = w
    mels = (rng.randn(B, T, M) * 0.5 - 2).astype(np.float32) * (m2w > 0)[:, :, None]
    pron = np.where(rng.rand(B, TW) < 0.2, 1, 0).astype(np.int32) * (wt > 0)
    return {"word_tokens": wt, "pron_modified": pron, "mel2word": m2w, "mels": mels,
            "word_lengths": wl, "mel_lengths": np.array(lengths, np.int32)}


class _NoDropoutBlock(jdisc.Disc2DBlockStack):
    dropout: float = 0.0


def _randomize(tree, seed, scale):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: (rng.randn(*np.shape(p)) * scale).astype(np.float32), tree)


def _starts(u, lengths):
    """The JAX discriminator's crop starts for uniforms u (float32 math)."""
    max_len = int(np.max(lengths))
    out = []
    for ui, win in zip(u, (32, 64, 128)):
        s = int(np.floor(np.float32(ui) * np.float32(max(max_len - win, 0) + 1)))
        out.append(min(max(s, 0), max(T - win, 0)))
    return np.array(out, np.int64)


def _ported_task(params_g, params_d, bank, **cfg):
    task = DictTTSTask({**CFG, "disc_dropout": 0.0, **cfg}, bank=bank, device="cpu")
    task.build_state(0)
    load_jax_params(task.model, params_g)
    load_jax_params(task.disc, params_d)
    return task


def _compare_grads(module, jax_grads, scale_tol):
    ref = jax_params_to_state(module, jax.device_get(jax_grads))
    named = dict(module.named_parameters())
    assert set(named) == set(ref)
    top = max(np.abs(np.asarray(g)).max() for g in ref.values())
    for name, g in ref.items():
        got = named[name].grad
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=1e-3, atol=scale_tol * top,
                                   err_msg=name)


def test_gen_and_disc_losses_and_gradients_match_jax(monkeypatch):
    bank, batch = _bank(0), _batch(1)
    jt = JTask(dict(CFG), None)
    state = jax.eval_shape(lambda r: {k: v for k, v in jt.build_state(r).items()
                                      if k.startswith("params")}, jax.random.PRNGKey(0))
    params_g = _randomize(state["params_g"], 2, 0.2)
    params_d = _randomize(state["params_d"], 3, 0.05)
    wt = batch["word_tokens"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = jnp.asarray(bank["keys"][wt])
    jbatch.update(keys=keys, values=keys, **{k: jnp.asarray(bank[k][wt])
                                             for k in ("key_map", "pinyin", "pinyin_map")})
    rng = np.random.RandomState(4)
    eps = rng.randn(B, T // 4, CFG["latent_size"]).astype(np.float32)
    u = np.array([0.3, 0.8, 0.45], np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(u))
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", _NoDropoutBlock)
    key = jax.random.PRNGKey(5)
    (loss_g, (g_losses, out)), grads_g = jax.jit(
        jax.value_and_grad(lambda pg, pd, bt, k: jt._gen_losses(pg, pd, bt, k, True, 1.0),
                           has_aux=True))(params_g, params_d, jbatch, key)
    (loss_d, d_losses), grads_d = jax.jit(jax.value_and_grad(jt._disc_losses, has_aux=True))(
        params_d, out["mel_out"], jbatch["mels"], jbatch["mel_lengths"], key)

    task = _ported_task(params_g, params_d, bank)
    tbatch = task.to_device(batch)
    starts = torch.tensor(_starts(u, batch["mel_lengths"]))
    task.model.train()
    task.disc.train()
    t_loss_g, t_losses, t_out = task._gen_losses(tbatch, None, True, 1.0, torch.tensor(eps), starts)
    t_loss_g.backward()
    assert all(p.grad is None for p in task.disc.parameters())  # frozen in the generator's pass
    t_loss_d, t_d_losses = task._disc_losses(t_out["mel_out"].detach(), tbatch["mels"],
                                             tbatch["mel_lengths"], None, starts)
    t_loss_d.backward()
    assert list(t_losses) == ["kl", "ssim", "l1", "wdur", "a"] and set(t_losses) == set(g_losses)
    for name, ref in [*g_losses.items(), *d_losses.items(), ("total", loss_g), ("disc", loss_d)]:
        got = {**t_losses, **t_d_losses, "total": t_loss_g, "disc": t_loss_d}[name]
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-6, err_msg=name)
    _compare_grads(task.model, grads_g, 1e-6)
    _compare_grads(task.disc, grads_d, 1e-6)


def test_optimizer_rule_matches_optax():
    """Both optimizers, fed identical gradients for 3 steps (norms above
    and below the clip), give optax's params. Short warmup and a large
    disc lr so the steps move the params."""
    cfg = dict(warmup_updates=1, disc_lr=0.05)
    task = DictTTSTask({**CFG, **cfg}, bank=_bank(0), device="cpu")
    task.build_state(1)
    jt = JTask({**CFG, **cfg}, None)
    for module, opt, tx, norm_key, sched in (
            (task.model, task.opt_g, jt.tx_g, "generator_grad_norm", task.schedule_g),
            (task.disc, task.opt_d, jt.tx_d, "discriminator_grad_norm", task.schedule_d)):
        params = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
        jp = {n: jnp.asarray(v) for n, v in params.items()}
        opt_state = tx.init(jp)
        step = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
            *tx.update(g, st, p)))
        rng = np.random.RandomState(7)
        for count, scale in enumerate((3.0, 1e-4, 0.5)):
            grads = {n: (rng.randn(*v.shape) * scale).astype(np.float32) for n, v in params.items()}
            jp, opt_state = step({n: jnp.asarray(g) for n, g in grads.items()}, opt_state, jp)
            for n, p in module.named_parameters():
                p.grad = torch.tensor(grads[n])
            optimizer_step(opt, list(module.parameters()), task.cfg[norm_key], sched(count))
        moved = 0.0
        for n, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), rtol=0, atol=1e-6, err_msg=n)
            moved = max(moved, float(np.abs(np.asarray(jp[n]) - params[n]).max()))
        assert moved > 1e-3


def _state_copy(task):
    return {k: (v.detach().clone() if torch.is_tensor(v) else v)
            for k, v in {**dict(task.model.named_parameters()), **{f"d.{n}": p for n, p in
                                                                   task.disc.named_parameters()}}.items()}


def _assert_same(a, b, prefix):
    for k in a:
        if k.startswith(prefix):
            assert torch.equal(a[k], b[k]), k


def _as_built(opt) -> bool:
    """An optimizer whose state (allocated when the task builds it) no update
    has touched: count 0, both moments zero."""
    return all(float(st["step"]) == 0 and not st["exp_avg"].any() and not st["exp_avg_sq"].any()
               for st in opt.state_dict()["state"].values())


def test_disc_gating_leaves_the_disc_and_its_optimizer_untouched():
    task = DictTTSTask({**CFG, "disc_start_steps": 1, "disc_interval": 2}, bank=_bank(0), device="cpu")
    task.build_state(2)
    batch = task.to_device(_batch(3))
    before = _state_copy(task)
    task.train_step(batch, torch.Generator().manual_seed(0))  # step 0 < disc_start_steps
    after = _state_copy(task)
    _assert_same(before, after, "d.")
    assert _as_built(task.opt_d) and task.updates_d == 0
    assert any(not torch.equal(before[k], after[k]) for k in before if not k.startswith("d."))
    task.train_step(batch, torch.Generator().manual_seed(1))  # step 1: 1 % disc_interval != 0
    _assert_same(after, _state_copy(task), "d.")
    assert task.updates_d == 0 and task.updates_g == 2
    task.train_step(batch, torch.Generator().manual_seed(2))  # step 2: the disc trains
    assert task.updates_d == 1 and task.step == 3
    assert any(not torch.equal(after[k], v) for k, v in _state_copy(task).items() if k.startswith("d."))


def test_nan_loss_skips_the_generator_update():
    task = DictTTSTask({**CFG, "disc_start_steps": 5}, bank=_bank(0), device="cpu")
    task.build_state(3)
    batch = _batch(4)
    batch["mels"][0, 3, 5] = np.nan
    before = _state_copy(task)
    opt_before = task.opt_g.state_dict()
    metrics = task.train_step(task.to_device(batch), torch.Generator().manual_seed(0))
    assert not torch.isfinite(metrics["total_loss"])
    _assert_same(before, _state_copy(task), "")
    assert task.opt_g.state_dict() == opt_before and task.updates_g == 0 and task.step == 1


def test_trainer_checkpoints_and_resumes_exactly(tmp_path):
    bank = _bank(0)
    batches = [_batch(s) for s in (5, 6)]

    def run(work_dir, max_updates):
        task = DictTTSTask(dict(CFG, dropout=0.1, predictor_dropout=0.2), bank=bank, device="cpu")
        Trainer(str(work_dir), max_updates=max_updates, val_check_interval=1, num_ckpt_keep=2,
                device="cpu").fit(task, batches, [batches[0]])
        return task

    straight = run(tmp_path / "a", 3)
    run(tmp_path / "b", 2)
    ckpts = get_all_ckpts(str(tmp_path / "b"))
    assert [os.path.basename(c) for c in ckpts] == ["model_ckpt_steps_2.ckpt", "model_ckpt_steps_1.ckpt"]
    assert not [f for f in os.listdir(tmp_path / "b") if f.endswith(".part")]
    resumed = run(tmp_path / "b", 3)
    assert resumed.step == straight.step == 3 and resumed.updates_d == 3
    for (n, a), (_, b) in zip(straight.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), n
    for (n, a), (_, b) in zip(straight.disc.state_dict().items(), resumed.disc.state_dict().items()):
        assert torch.equal(a, b), n
    state = torch.load(ckpts[0], weights_only=True)["state"]  # the bank is not in it
    assert set(state) == {"params_g", "params_d", "opt_g", "opt_d", "step", "updates_g", "updates_d"}
    assert not any(k.startswith("bank") for k in state["params_g"])


def test_test_step_matches_the_serving_path():
    """The task's inference step is the serving slice's acoustic pass."""
    bank, batch = _bank(0), _batch(7)
    task = DictTTSTask(dict(CFG, max_frames=96), bank=bank, device="cpu")
    task.build_state(4)
    noise = torch.randn((B, 96 // 4, CFG["latent_size"]), generator=torch.Generator().manual_seed(0))
    out = task.test_step(task.to_device(batch), noise=noise)
    vocoder = HifiGanGenerator(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                               upsample_initial_channel=16, resblock_kernel_sizes=(3,))
    server = DictTTSServer(task.model, vocoder, bank, max_frames=96, device="cpu")
    n = batch["word_lengths"]
    ref = server.acoustic_batch([Request(batch["word_tokens"][b, :n[b]], batch["pron_modified"][b, :n[b]])
                                 for b in range(B)], noise=noise)
    for key in ("mel_out", "mel2word", "pron_attn", "pinyin_pred"):
        torch.testing.assert_close(out[key], ref[key], rtol=0, atol=0, msg=key)
    assert (out["mel2word"] > 0).sum() > 0


def test_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError):
        Trainer("unused")
    with pytest.raises(RuntimeError):
        DictTTSTask()
