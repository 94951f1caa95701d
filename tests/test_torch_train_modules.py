"""Port parity of the training modules: sequence helpers, the losses, the
multi-window discriminator (with given crop starts), the prior flow's
forward direction, FVAE and DictTTS in training mode, the schedules, and
dropout drawn from an explicit generator.

Parameters are flax-initialised and replaced by seeded random values, and
both frameworks get the same numpy posterior noise (the JAX draw is
replaced by it). Dropout is 0 on both sides where outputs are compared.

Tolerances: losses atol 1e-5 (f32 reductions of O(1) values; SSIM through
two f32 matrix products); modules atol 5e-5 (f32 on the CPU, summation
order only, through a few dozen convolutions); schedules rtol 1e-6 (the
JAX package evaluates them in f32, the port in f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models import discriminator as jdisc
from dicttts_tpu.models.dict_encoder import DictMsg as JMsg
from dicttts_tpu.models.dict_tts import DictTTS as JDictTTS
from dicttts_tpu.models.flows import ResidualCouplingBlock as JFlow
from dicttts_tpu.models.fvae import FVAE as JFVAE
from dicttts_tpu.ops import seq as jseq
from dicttts_tpu.train import losses as JL
from dicttts_tpu.utils import schedulers as jsched
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models.dict_encoder import DictMsg
from dicttts_tpu_torch.models.dict_tts import DictTTS
from dicttts_tpu_torch.models.discriminator import MultiWindowDiscriminator
from dicttts_tpu_torch.models.flows import ResidualCouplingBlock
from dicttts_tpu_torch.models.fvae import FVAE
from dicttts_tpu_torch.ops import seq as tseq
from dicttts_tpu_torch.train import losses as TL
from dicttts_tpu_torch.utils import schedulers as tsched

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ATOL = 5e-5


def _randomize(params, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: (rng.randn(*np.shape(p)) * scale).astype(np.float32), params)


def _mels(seed, B=3, T=48, M=20, lengths=(48, 30, 0)):
    """Random mels, zero past each row's length (the collater's padding)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, M).astype(np.float32)
    for b, n in enumerate(lengths):
        x[b, n:] = 0
    return x


def _np(x):
    return x.detach().numpy()


def test_mel2token_to_dur_and_masked_mean():
    m2t = np.array([[1, 1, 2, 2, 2, 4, 0, 0], [1, 2, 3, 3, 0, 0, 0, 0]], np.int32)
    np.testing.assert_array_equal(tseq.mel2token_to_dur(torch.tensor(m2t), 5).numpy(),
                                  np.asarray(jseq.mel2token_to_dur(jnp.asarray(m2t), 5)))
    rng = np.random.RandomState(0)
    x, mask = rng.randn(2, 7, 3).astype(np.float32), (rng.rand(2, 7, 1) > 0.4).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):
        np.testing.assert_allclose(tseq.masked_mean(torch.tensor(x), torch.tensor(m)).item(),
                                   float(jseq.masked_mean(jnp.asarray(x), jnp.asarray(m))), atol=1e-6)


@pytest.mark.parametrize("name", ["l1", "mse", "ssim", "gdl"])
def test_mel_losses(name):
    target = _mels(1)
    pred = target + 0.3 * np.random.RandomState(2).randn(*target.shape).astype(np.float32)
    got = TL.MEL_LOSS_FNS[name](torch.tensor(pred), torch.tensor(target)).item()
    ref = float(JL.MEL_LOSS_FNS[name](jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_loss_spec_word_dur_lsgan_and_kl_clamp():
    spec = "ssim:0.5|l1:0.5|gdl"
    assert TL.parse_mel_loss_spec(spec) == JL.parse_mel_loss_spec(spec)
    target = _mels(3)
    pred = _mels(4)
    got = TL.add_mel_losses(TL.parse_mel_loss_spec(spec), torch.tensor(pred), torch.tensor(target), {})
    ref = JL.add_mel_losses(JL.parse_mel_loss_spec(spec), jnp.asarray(pred), jnp.asarray(target), {})
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), atol=1e-5, err_msg=k)
    rng = np.random.RandomState(5)
    dur = rng.rand(2, 6).astype(np.float32) * 2
    m2w = np.array([[1, 1, 2, 3, 3, 3, 4, 5, 0, 0], [1, 2, 2, 2, 3, 0, 0, 0, 0, 0]], np.int32)
    wl = np.array([5, 3], np.int32)
    for scale in ("log", "linear"):
        np.testing.assert_allclose(
            TL.word_dur_loss(torch.tensor(dur), torch.tensor(m2w), torch.tensor(wl), scale).item(),
            float(JL.word_dur_loss(jnp.asarray(dur), jnp.asarray(m2w), jnp.asarray(wl), scale)),
            atol=1e-5)
    d_real, d_fake = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(TL.lsgan_g_loss(torch.tensor(d_fake)).item(),
                               float(JL.lsgan_g_loss(jnp.asarray(d_fake))), atol=1e-6)
    np.testing.assert_allclose(TL.lsgan_d_loss(torch.tensor(d_real), torch.tensor(d_fake)).item(),
                               float(JL.lsgan_d_loss(jnp.asarray(d_real), jnp.asarray(d_fake))),
                               atol=1e-6)
    for kl in (0.5, 0.001):
        assert TL.clamp_kl(torch.tensor(kl)).item() == pytest.approx(float(JL.clamp_kl(jnp.asarray(kl))))
    kl = torch.tensor(0.001, requires_grad=True)
    TL.clamp_kl(kl).backward()
    assert kl.grad.item() == 0.0  # below the floor the term passes no gradient


class _NoDropoutBlock(jdisc.Disc2DBlockStack):
    """The JAX block with its hard-coded 0.25 dropout set to 0, so both
    sides run the discriminator deterministically in train mode."""

    dropout: float = 0.0


@pytest.mark.parametrize("T,lengths,starts", [(160, (160, 140, 90), (5, 40, 17)),
                                               (100, (100, 70, 64), (9, 3, 0))])
def test_discriminator_with_given_crops(T, lengths, starts, monkeypatch):
    M, hidden = 20, 8
    mels = _mels(6, B=3, T=T, M=M, lengths=lengths)
    jm = jdisc.MultiWindowDiscriminator(freq_length=M, hidden_size=hidden)
    args = (jnp.asarray(mels), jnp.asarray(np.array(lengths, np.int32)), jnp.asarray(np.array(starts)))
    params = _randomize(jax.eval_shape(lambda r: jm.init(r, *args)["params"], jax.random.PRNGKey(0)),
                        7, 0.2)
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", _NoDropoutBlock)
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, deterministic=False,
                                         rngs={"dropout": jax.random.PRNGKey(1)}))(params, *args)
    tm = load_jax_params(MultiWindowDiscriminator(freq_length=M, hidden_size=hidden, dropout_rate=0.0),
                         params).train()
    out = tm(torch.tensor(mels), torch.tensor(np.array(lengths, np.int32)), torch.tensor(starts))
    np.testing.assert_allclose(_np(out["y"]), np.asarray(ref["y"]), atol=ATOL)
    np.testing.assert_array_equal(out["start_frames"].numpy(), np.asarray(ref["start_frames"]))
    np.testing.assert_array_equal(out["win_valid"].numpy(), np.asarray(ref["win_valid"]))
    assert len(out["h"]) == len(ref["h"]) == 9
    for a, b in zip(out["h"], ref["h"]):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


def test_discriminator_draws_crops_from_a_generator():
    mels = torch.tensor(_mels(8, B=2, T=200, M=20, lengths=(180, 150)))
    tm = MultiWindowDiscriminator(freq_length=20, hidden_size=8).train()
    lengths = torch.tensor([180, 150], dtype=torch.int32)
    outs = [tm(mels, lengths, generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    torch.testing.assert_close(outs[0]["y"], outs[1]["y"], rtol=0, atol=0)
    starts = outs[0]["start_frames"].numpy()
    assert all(0 <= s <= 180 - w for s, w in zip(starts, (32, 64, 128)))
    assert not torch.equal(outs[0]["y"], outs[2]["y"])
    with pytest.raises(ValueError):
        tm(mels, lengths)  # no crops and no generator


def test_prior_flow_forward_and_round_trip():
    rng = np.random.RandomState(9)
    B, T, C, gin = 2, 10, 4, 12
    z = rng.randn(B, T, C).astype(np.float32)
    g = rng.randn(B, T, gin).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 7:] = 0
    jm = JFlow(C, 8, 3, 1, 4, n_flows=3, gin_channels=gin)
    args = (jnp.asarray(z), jnp.asarray(mask), jnp.asarray(g))
    p = _randomize(jax.eval_shape(lambda r: jm.init(r, *args)["params"], jax.random.PRNGKey(2)), 10)
    ref = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(p, *args))
    tm = load_jax_params(ResidualCouplingBlock(C, 8, 3, 1, 4, 3, gin), p)
    tz, tmask, tg = map(torch.tensor, (z, mask, g))
    out = tm(tz, tmask, tg)
    np.testing.assert_allclose(_np(out), ref, atol=ATOL)
    np.testing.assert_allclose(_np(tm.reverse(out, tmask, tg)), z * mask, atol=ATOL)


def test_fvae_train(monkeypatch):
    rng = np.random.RandomState(11)
    B, T, gin, latent, out_dims = 2, 24, 16, 4, 8
    g = rng.randn(B, T, gin).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 18:] = 0
    x = rng.randn(B, T, out_dims).astype(np.float32) * mask
    eps = rng.randn(B, T // 4, latent).astype(np.float32)
    jm = JFVAE(in_out_channels=out_dims, hidden_channels=16, latent_size=latent, kernel_size=5,
               enc_n_layers=2, dec_n_layers=3, gin_channels=gin, strides=(4,), flow_hidden=8,
               flow_kernel_size=3, flow_n_steps=2)
    jargs = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    p = _randomize(jax.eval_shape(lambda r: jm.init({"params": r, "sample": r}, *jargs)["params"],
                                  jax.random.PRNGKey(3)), 12)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    ref = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, rngs={"sample": jax.random.PRNGKey(5)}))(
        p, *jargs)
    tm = load_jax_params(FVAE(out_dims, 16, latent, 5, 2, 3, gin, (4,), 8, 3, 2), p)
    out = tm(*map(torch.tensor, (x, mask, g)), eps=torch.tensor(eps))
    for name, a, b in zip(("x_recon", "loss_kl", "z_p", "m_q", "logs_q"), out, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL, err_msg=name)


KW = dict(word_vocab=40, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, pinyin_vocab=30,
          dur_predictor_layers=2, dur_predictor_kernel=3, dur_predictor_chans=16,
          frames_multiple=4, out_dims=16, latent_size=4, fvae_enc_dec_hidden=16,
          fvae_kernel_size=5, fvae_enc_n_layers=2, fvae_dec_n_layers=2, prior_flow_hidden=8,
          prior_flow_kernel_size=3, prior_flow_n_blocks=2, fvae_strides=4)
V, L, E, P = 40, 10, 32, 6


def _dict_tts_data(seed, B=2, TW=8, T=48):
    rng = np.random.RandomState(seed)
    bank = (rng.randn(V, L, E) * 0.5).astype(np.float32)
    km = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    pin = rng.randint(1, 30, (V, P)).astype(np.int32)
    pm = np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1))
    wt = rng.randint(3, V, (B, TW)).astype(np.int32)
    wt[:, 0], wt[1, 6:] = 1, 0
    m2w = np.zeros((B, T), np.int32)
    m2w[0, :44] = np.repeat(np.arange(1, 9), [5, 6, 4, 7, 5, 6, 6, 5])
    m2w[1, :30] = np.repeat(np.arange(1, 7), [4, 6, 5, 5, 6, 4])
    mels = rng.randn(B, T, KW["out_dims"]).astype(np.float32) * (m2w > 0)[:, :, None]
    pron = np.zeros((B, TW), np.int32)
    pron[0, 3] = 2
    eps = rng.randn(B, T // 4, KW["latent_size"]).astype(np.float32)
    return bank, km, pin, pm, wt, m2w, mels, pron, eps


def test_dict_tts_train(monkeypatch):
    """Training forward: the port on the un-gathered bank (K1 path), JAX on
    gathered banks (eager S2PA); dropout 0, the same posterior noise."""
    bank, km, pin, pm, wt, m2w, mels, pron, eps = _dict_tts_data(13)
    jm = JDictTTS(dropout=0.0, predictor_dropout=0.0, **KW)
    keys = jnp.asarray(bank[wt])
    dm = JMsg(keys, keys, jnp.asarray(km[wt]), jnp.asarray(pin[wt]), jnp.asarray(pm[wt]))
    jargs = (jnp.asarray(wt), dm, jnp.asarray(pron))
    jkw = dict(mel2word=jnp.asarray(m2w), tgt_mels=jnp.asarray(mels))
    shapes = jax.eval_shape(lambda r: jm.init({"params": r, "sample": r}, *jargs, **jkw)["params"],
                            jax.random.PRNGKey(0))
    params = _randomize(shapes, 14)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    ref = jax.jit(lambda p: jm.apply({"params": p}, *jargs, **jkw,
                                     rngs={"sample": jax.random.PRNGKey(1)}))(params)
    tm = load_jax_params(DictTTS(dict_embed_dim=E, dropout=0.0, predictor_dropout=0.0, **KW),
                         params).train()
    tbank = torch.tensor(bank)
    tdm = DictMsg(tbank, tbank, torch.tensor(km[wt]), torch.tensor(pin[wt]), torch.tensor(pm[wt]))
    out = tm(torch.tensor(wt), tdm, torch.tensor(pron), mel2word=torch.tensor(m2w),
             tgt_mels=torch.tensor(mels), noise=torch.tensor(eps))
    for key in ("mel_out", "kl", "dur", "z_p", "m_q", "logs_q", "pron_attn", "dict_attn"):
        np.testing.assert_allclose(_np(out[key]), np.asarray(ref[key]), atol=ATOL, err_msg=key)


def test_dropout_follows_the_generator():
    bank, km, pin, pm, wt, m2w, mels, _, _ = _dict_tts_data(15)
    tm = DictTTS(dict_embed_dim=E, **KW).train()
    tbank = torch.tensor(bank)
    tdm = DictMsg(tbank, tbank, torch.tensor(km[wt]), torch.tensor(pin[wt]), torch.tensor(pm[wt]))
    args = (torch.tensor(wt), tdm)
    kw = dict(mel2word=torch.tensor(m2w), tgt_mels=torch.tensor(mels))
    runs = [tm(*args, **kw, generator=torch.Generator().manual_seed(s))["mel_out"] for s in (0, 0, 1)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError):
        tm(*args, **kw)  # training-mode dropout needs a generator
    tm.eval()
    ev = [tm(*args, **kw, generator=torch.Generator().manual_seed(s))["dur"] for s in (0, 1)]
    torch.testing.assert_close(ev[0], ev[1], rtol=0, atol=0)  # eval: no dropout


def test_schedules_match_per_count():
    for count in (0, 1, 2, 100, 7999, 8000, 8001, 300000):
        np.testing.assert_allclose(tsched.rsqrt_schedule(1.0, 8000, 192)(count),
                                   float(jsched.rsqrt_schedule(1.0, 8000, 192)(count)), rtol=1e-6)
    for count in (0, 1, 39999, 40000, 80000, 123456):
        np.testing.assert_allclose(tsched.step_decay_schedule(1e-4, 40000, 0.5)(count),
                                   float(jsched.step_decay_schedule(1e-4, 40000, 0.5)(count)),
                                   rtol=1e-6)
