"""Port parity of the PortaSpeech training tasks (dicttts_tpu_torch.train.
tasks.ps_adv and ps_flow) against the JAX tasks: the recipe's values, and
the generator losses and every gradient leaf of ``_gen_losses`` from the
same state, for ps_adv (KL with its clamp, SSIM + L1, the word-duration
loss and the LSGAN term, plus the discriminator's losses and gradients)
and for ps_flow with the post-net Glow (the NLL added to the total; the
discriminator off).

The JAX side runs under ``jax.jit``: at these widths XLA compiles
``_gen_losses`` and its gradient in ~8 s, where the eager run takes ~75 s
on this file's first call (each primitive compiled on its own). Dropout is 0 on both
sides (the discriminator's hard-coded 0.25 is replaced on the JAX side),
and the posterior noise and the crop starts are pinned: the JAX draws are
replaced by numpy arrays, the port is given the same values.

Tolerances (as tests/test_torch_train_task.py): losses rtol 1e-5 / atol
1e-6; gradients rtol 1e-3 / atol 1e-6 of the largest gradient of their
parameter set (f32 on the CPU through the whole generator and back).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.config import load_config
from dicttts_tpu.models import discriminator as jdisc
from dicttts_tpu.train.tasks.ps_adv import PortaSpeechAdvTask as JAdv
from dicttts_tpu.train.tasks.ps_flow import PortaSpeechFlowTask as JFlow
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params
from dicttts_tpu_torch.train.tasks import ps_adv as tps
from dicttts_tpu_torch.train.tasks.ps_adv import PortaSpeechAdvTask
from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

RECIPE = os.path.join(os.path.dirname(__file__), "..", "dicttts_tpu", "configs", "tts")
NV, B, TPH, TW, T, M = 30, 2, 16, 6, 96, 80
CFG = dict(n_vocab=NV, hidden_size=16, num_heads=2, enc_layers=1, word_enc_layers=1,
           enc_ffn_kernel_size=3, dropout=0.0, predictor_dropout=0.0, dur_predictor_layers=2,
           dur_predictor_kernel=3, latent_size=4, fvae_enc_dec_hidden=8, fvae_kernel_size=3,
           fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8, glow_kernel_size=3,
           prior_glow_n_blocks=1, mel_disc_hidden_size=8, post_glow_hidden=8, post_glow_n_blocks=2,
           post_glow_n_block_layers=1, share_wn_layers=2)
FLOW = dict(CFG, use_post_glow=True)
U = np.array([0.3, 0.8, 0.45], np.float32)  # the discriminator's crop-start uniforms


def batch(seed, lengths=(T, 70)):
    """Collater-format word batch: BOS phone/word, words of 1-3 phones and
    8-20 frames, mels zero past each row's length, phones and words
    padded."""
    rng = np.random.RandomState(seed)
    ph2word = np.zeros((B, TPH), np.int32)
    m2w = np.zeros((B, T), np.int32)
    wl = np.zeros(B, np.int32)
    for b, n_frames in enumerate(lengths):
        f, w, p = 0, 0, 0
        while f < n_frames and w < TW:
            n_ph = min(rng.randint(1, 4), TPH - p)
            ph2word[b, p:p + n_ph] = w + 1
            d = min(rng.randint(8, 21), n_frames - f)
            m2w[b, f:f + d] = w + 1
            f, w, p = f + d, w + 1, p + n_ph
        wl[b] = w
    txt = np.where(ph2word > 0, rng.randint(1, NV, ph2word.shape), 0).astype(np.int32)
    wt = np.where(np.arange(TW)[None] < wl[:, None], rng.randint(3, 50, (B, TW)), 0).astype(np.int32)
    mels = (rng.randn(B, T, M) * 0.5 - 2).astype(np.float32) * (m2w > 0)[:, :, None]
    return {"txt_tokens": txt, "ph2word": ph2word, "word_tokens": wt, "mel2word": m2w, "mels": mels,
            "word_lengths": wl, "mel_lengths": np.array(lengths, np.int32)}


def starts(lengths):
    """The JAX discriminator's crop starts for U (float32 math)."""
    max_len = int(np.max(lengths))
    out = []
    for ui, win in zip(U, (32, 64, 128)):
        s = int(np.floor(np.float32(ui) * np.float32(max(max_len - win, 0) + 1)))
        out.append(min(max(s, 0), max(T - win, 0)))
    return torch.tensor(out, dtype=torch.int64)


def eps(seed):
    return np.random.RandomState(seed).randn(B, T // 4, CFG["latent_size"]).astype(np.float32)


class _NoDropoutBlock(jdisc.Disc2DBlockStack):
    dropout: float = 0.0


def pin_jax(monkeypatch, noise):
    """The JAX draws: the posterior noise, the crop-start uniforms, and no
    discriminator dropout."""
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(noise, dtype) if tuple(shape) == noise.shape else normal(key, shape, dtype)))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U))
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", _NoDropoutBlock)


def jax_state(jt, seed):
    """Seeded random parameters in the shapes of the JAX task's state (the
    Glow's 1x1 mixing matrices orthogonal with scaled columns, as
    well conditioned as flax's init), and ``jt.build_state``'s side
    effects (the two-stage optimizers) on ``jt``."""
    shapes = jax.eval_shape(jt.build_state, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    rand = lambda tree, scale: jax.tree.map(  # noqa: E731
        lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), tree)
    params_g, params_d = rand(shapes["params_g"], 0.2), rand(shapes["params_d"], 0.05)
    for name in params_g.get("post_flow", {}):
        if name.startswith("invconv_"):
            q = np.linalg.qr(rng.randn(4, 4))[0] * [1.3, 0.8, 1.1, 0.9]
            params_g["post_flow"][name]["weight"] = q.astype(np.float32)
    return params_g, params_d


def ported(task_cls, cfg, params_g, params_d):
    task = task_cls({**cfg, "disc_dropout": 0.0}, device="cpu")
    task.build_state(0)
    load_jax_params(task.model, params_g)
    load_jax_params(task.disc, params_d)
    return task


def compare_grads(module, jax_grads):
    ref = jax_params_to_state(module, jax.device_get(jax_grads))
    named = dict(module.named_parameters())
    assert set(named) == set(ref)
    top = max(np.abs(np.asarray(g)).max() for g in ref.values())
    for name, g in ref.items():
        got = named[name].grad
        got = np.zeros_like(np.asarray(g)) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-3, atol=1e-6 * top, err_msg=name)


def test_recipe_defaults_match_the_jax_recipe():
    recipe = load_config(os.path.join(RECIPE, "ps_adv.yaml"))
    flow = load_config(os.path.join(RECIPE, "ps_flow.yaml"))
    internal = {"n_vocab", "max_frames", "amp", "accumulate_grad_batches"}
    for key, value in tps.DEFAULTS.items():
        if key not in internal:
            assert recipe[key] == value, key
    assert {k: flow[k] for k in flow if k.startswith("post_glow") or k == "two_stage"} == {
        k: tps.DEFAULTS[k] for k in flow if k.startswith("post_glow") or k == "two_stage"}
    jt = JAdv(recipe, None)
    task = PortaSpeechAdvTask(device="cpu")
    model = task.build_model()
    assert model.predictor_grad == jt.model.predictor_grad and model.num_spk == jt.model.num_spk
    assert model.dur_predictor.dropout_rate == jt.model.predictor_dropout
    assert task.lambda_adv == jt.lambda_adv and jt.infer_max_frames == task.cfg["max_frames"]
    jf = JFlow(dict(recipe, use_post_glow=True), None)
    tf = PortaSpeechFlowTask({"use_post_glow": True}, device="cpu")
    assert tf.lambda_adv == jf.lambda_adv == 0.0 and tf.staged and jf.two_stage
    assert tf.post_glow_training_start == jf.post_glow_training_start
    m = tf.build_model()
    assert m.post_noise_scale == jf.model.post_noise_scale and len(m.post_flow.shared_wn) == 3


@pytest.mark.parametrize("flow", [False, True], ids=["ps_adv", "ps_flow_post_glow"])
def test_gen_and_disc_losses_and_gradients_match_jax(flow, monkeypatch):
    cfg = FLOW if flow else CFG
    jt = (JFlow if flow else JAdv)(dict(cfg), None)
    params_g, params_d = jax_state(jt, 2)
    b = batch(1)
    noise = eps(4)
    pin_jax(monkeypatch, noise)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    key = jax.random.PRNGKey(5)
    (loss_g, (g_losses, out)), grads_g = jax.jit(jax.value_and_grad(
        lambda pg: jt._gen_losses(pg, params_d, jb, key, True, 1.0), has_aux=True))(params_g)
    (loss_d, d_losses), grads_d = jax.jit(jax.value_and_grad(jt._disc_losses, has_aux=True))(
        params_d, out["mel_out"], jb["mels"], jb["mel_lengths"], key)

    task = ported(PortaSpeechFlowTask if flow else PortaSpeechAdvTask, cfg, params_g, params_d)
    tb = task.to_device(b)
    st = starts(b["mel_lengths"])
    task.model.train()
    task.disc.train()
    t_loss_g, t_losses, t_out = task._gen_losses(tb, None, True, 1.0, torch.tensor(noise), st)
    t_loss_g.backward()
    assert all(p.grad is None for p in task.disc.parameters())
    t_loss_d, t_d_losses = task._disc_losses(t_out["mel_out"].detach(), tb["mels"],
                                             tb["mel_lengths"], None, st)
    t_loss_d.backward()
    want = ["kl", "ssim", "l1", "wdur"] + (["postflow"] if flow else ["a"])
    assert list(t_losses) == want and set(t_losses) == set(g_losses)
    for name, ref in [*g_losses.items(), *d_losses.items(), ("total", loss_g), ("disc", loss_d)]:
        got = {**t_losses, **t_d_losses, "total": t_loss_g, "disc": t_loss_d}[name]
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(g_losses["kl"]) > CFG.get("kl_min", 0.002)  # the clamp does not hide the KL
    compare_grads(task.model, grads_g)
    compare_grads(task.disc, grads_d)
