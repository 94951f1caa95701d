"""Port parity of the FastSpeech2 model and its registries
(dicttts_tpu_torch.models.fastspeech2, conformer, tacotron; ops/pitch.py)
against the JAX package's, on the CPU.

- ``f0_to_coarse`` exactly the JAX buckets on a dense sweep of f0 (0 Hz,
  unvoiced and padding frames among them), ``denorm_f0`` exactly for the
  recipe's 'standard' with mean 0 and std 1 (f0 in Hz) and for 'none',
  within 2 ulps for 'log' (2^x) and a scaled 'standard' (XLA fuses f0 *
  std + mean into one rounding);
- each encoder of the registry (with the conv decoder) and each decoder
  (with the rel_fft encoder): a forward with the ground-truth mel2ph, f0
  and uv, and an inference at ``max_frames`` whose mel2ph must be equal;
- the BertEncoder scaffold (FFT blocks and the char head), with a padded
  row;
- the energy, RefEncoder and speaker paths on, and the gradients of every
  parameter through the straight-through ``predictor_grad`` mixing
  against ``jax.grad``.

Both sides get the same seeded random parameters (a flax tree loaded by
``convert.fastspeech2_state``). f32 on the CPU, dropout off; the JAX
model runs under ``jax.jit``. Tolerances: atol 1e-4 on values of O(1)
(summation orders only, through ~10 layers); the RNN entries (tacotron's
GRU, tacotron2's and the rnn decoder's LSTMs) atol 1e-3, their recurrences
compounding the differences over the sequence. Gradients rtol 1e-3 with
atol 1e-6 of the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models.fastspeech2 import FastSpeech2 as JFastSpeech2
from dicttts_tpu.models.tacotron import BertEncoderScaffold as JBertEncoderScaffold
from dicttts_tpu.ops import pitch as jpitch
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params
from dicttts_tpu_torch.models.fastspeech2 import FS_DECODERS, FS_ENCODERS, FastSpeech2
from dicttts_tpu_torch.models.tacotron import BertEncoderScaffold
from dicttts_tpu_torch.ops import pitch as tpitch

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

NV, B, TT, TM, MAX_FRAMES = 20, 2, 10, 40, 48
KW = dict(n_vocab=NV, hidden_size=32, enc_layers=1, dec_layers=2, enc_ffn_kernel_size=3,
          dec_ffn_kernel_size=5, num_heads=2, dropout=0.0, predictor_dropout=0.0,
          predictor_kernel=3, pitch_norm="standard")
RNN = ("tacotron", "tacotron2", "rnn")
PAIRS = [(e, "conv") for e in ("fft", "rel_fft", "conformer", "tacotron", "tacotron2")] + [
    ("rel_fft", d) for d in ("fft", "wn", "conformer", "rnn")]


def batch(seed):
    """Row 0: 8 phones; row 1: 5 phones (padded), fewer frames; f0 in Hz
    with unvoiced frames (uv 1, f0 interpolated through them, as the
    dataset gives it) and padding frames."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros((B, TT), np.int32)
    mel2ph = np.zeros((B, TM), np.int32)
    for b, (n_ph, n_fr) in enumerate(((8, TM), (5, 27))):
        tokens[b, :n_ph] = rng.randint(1, NV, n_ph)
        cuts = np.sort(rng.choice(np.arange(1, n_fr), n_ph - 1, replace=False))
        mel2ph[b, :n_fr] = np.searchsorted(cuts, np.arange(n_fr), side="right") + 1
    uv = ((rng.rand(B, TM) < 0.25) | (mel2ph == 0)).astype(np.float32)
    f0 = (rng.uniform(90, 320, (B, TM)) * (mel2ph > 0)).astype(np.float32)
    return tokens, mel2ph, f0, uv


def random_params(jm, seed, tokens, mel2ph, extra=None):
    rng = np.random.RandomState(seed)
    extra = extra or {}
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.asarray(tokens), jnp.asarray(mel2ph),
                                              f0=jnp.zeros(mel2ph.shape), uv=jnp.zeros(mel2ph.shape),
                                              **extra)["params"], jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)
    params["dur_predictor"]["out"]["bias"] = np.full((1,), 1.2, np.float32)  # ~2-3 frames a phone
    return params


def models(enc, dec, seed=1, **kw):
    tokens, mel2ph, _, _ = batch(0)
    cfg = dict(KW, encoder_type=enc, decoder_type=dec, **kw)
    jm = JFastSpeech2(**cfg)
    extra = {}
    if kw.get("num_spk"):
        extra["spk_ids"] = jnp.zeros((B,), jnp.int32)
    if kw.get("use_ref_enc"):
        extra["ref_mels"] = jnp.zeros((B, TM, 80))
    params = random_params(jm, seed, tokens, mel2ph, extra)
    tm = load_jax_params(FastSpeech2(**cfg), params).eval()
    return jm, params, tm


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_registries_hold_every_entry():
    assert set(FS_ENCODERS) == {"fft", "rel_fft", "conformer", "tacotron", "tacotron2"}
    assert set(FS_DECODERS) == {"fft", "conv", "wn", "conformer", "rnn"}


def test_pitch_functions_match_jax():
    rng = np.random.RandomState(0)
    f0 = np.concatenate([np.linspace(0, 1300, 200001), [0.0, 1e-6, 49.9, 50.0, 1100.0, 5000.0],
                         rng.uniform(0, 1200, 10000)]).astype(np.float32)
    got = tpitch.f0_to_coarse(torch.tensor(f0)).numpy()
    want = np.asarray(jax.jit(jpitch.f0_to_coarse)(jnp.asarray(f0)))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() == 1 and got.max() == 255 and got[f0 == 0].max() == 1
    _, mel2ph, hz, uv = batch(3)
    norm = (rng.randn(*hz.shape) * 2).astype(np.float32)
    for pitch_norm, mean, std, x in (("standard", 0.0, 1.0, hz), ("standard", 180.0, 40.0, norm),
                                     ("log", 0.0, 1.0, norm + 7.0), ("none", 0.0, 1.0, norm * 100)):
        for with_uv in (False, True):
            args = (uv if with_uv else None, pitch_norm, mean, std)
            pad = mel2ph == 0
            want = np.asarray(jax.jit(lambda v, u, p: jpitch.denorm_f0(
                v, u, pitch_norm, mean, std, pitch_padding=p))(
                jnp.asarray(x), None if args[0] is None else jnp.asarray(args[0]), jnp.asarray(pad)))
            got = tpitch.denorm_f0(torch.tensor(x), None if args[0] is None else torch.tensor(args[0]),
                                   pitch_norm, mean, std, pitch_padding=torch.tensor(pad)).numpy()
            if pitch_norm == "log" or std != 1.0:  # XLA's exp2 and its fused multiply-add
                np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)  # round apart: 2 ulps
            else:
                np.testing.assert_array_equal(got, want)
            assert not got[pad].any() and (got >= 0).all()
            # the coarse buckets of the denormalized values, as the model takes them
            np.testing.assert_array_equal(tpitch.f0_to_coarse(torch.tensor(want)).numpy(),
                                          np.asarray(jpitch.f0_to_coarse(jnp.asarray(want))))


def _jax_forward(jm):
    def fwd(params, tokens, mel2ph, f0, uv, extra):
        return jm.apply({"params": params}, tokens, mel2ph, f0=f0, uv=uv, **extra)

    def infer(params, tokens, extra):
        return jm.apply({"params": params}, tokens, infer=True, max_frames=MAX_FRAMES, **extra)

    return jax.jit(fwd), jax.jit(infer)


@pytest.mark.parametrize("enc,dec", PAIRS, ids=[f"{e}-{d}" for e, d in PAIRS])
def test_registry_entry_matches_jax(enc, dec):
    jm, params, tm = models(enc, dec)
    tol = 1e-3 if enc in RNN or dec in RNN else 1e-4
    fwd, infer = _jax_forward(jm)
    tokens, mel2ph, f0, uv = batch(2)
    ref = fwd(params, *(jnp.asarray(a) for a in (tokens, mel2ph, f0, uv)), {})
    with torch.no_grad():
        out = tm(torch.tensor(tokens), torch.tensor(mel2ph), f0=torch.tensor(f0), uv=torch.tensor(uv))
    for key in ("dur", "pitch_pred", "f0_denorm", "decoder_inp", "mel_out"):
        np.testing.assert_allclose(_np(out[key]), _np(ref[key]), atol=tol, err_msg=key)
    ref = infer(params, jnp.asarray(tokens), {})
    with torch.no_grad():
        out = tm(torch.tensor(tokens), max_frames=MAX_FRAMES)
    m2p = _np(ref["mel2ph"])
    np.testing.assert_array_equal(_np(out["mel2ph"]), m2p)
    n = (m2p > 0).sum(1)
    assert n.min() > 0 and n.max() < MAX_FRAMES, n  # real and padding frames both present
    for key in ("dur", "pitch_pred", "f0_denorm", "mel_out"):
        np.testing.assert_allclose(_np(out[key]), _np(ref[key]), atol=tol, err_msg=key)


EXTRA = dict(use_energy_embed=True, use_ref_enc=True, num_spk=3)


def _extras(seed):
    rng = np.random.RandomState(seed)
    return {"spk_ids": np.array([2, 1], np.int32),
            "ref_mels": (rng.randn(B, 33, 80) * 0.5 - 2).astype(np.float32)}


def test_energy_ref_encoder_and_speaker_paths_match_jax():
    jm, params, tm = models("rel_fft", "conv", seed=4, **EXTRA)
    fwd, infer = _jax_forward(jm)
    tokens, mel2ph, f0, uv = batch(5)
    extra = _extras(6)
    energy = (np.random.RandomState(7).rand(B, TM) * 3 * (mel2ph > 0)).astype(np.float32)
    textra = {k: torch.tensor(v) for k, v in extra.items()}
    for e in (None, energy):
        jx = dict({k: jnp.asarray(v) for k, v in extra.items()}, **({} if e is None else {"energy": jnp.asarray(e)}))
        ref = fwd(params, *(jnp.asarray(a) for a in (tokens, mel2ph, f0, uv)), jx)
        with torch.no_grad():
            out = tm(torch.tensor(tokens), torch.tensor(mel2ph), f0=torch.tensor(f0),
                     uv=torch.tensor(uv), energy=None if e is None else torch.tensor(e), **textra)
        for key in ("dur", "pitch_pred", "energy_pred", "decoder_inp", "mel_out"):
            np.testing.assert_allclose(_np(out[key]), _np(ref[key]), atol=1e-4, err_msg=key)
    ref = infer(params, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in extra.items()})
    with torch.no_grad():
        out = tm(torch.tensor(tokens), max_frames=MAX_FRAMES, **textra)
    np.testing.assert_array_equal(_np(out["mel2ph"]), _np(ref["mel2ph"]))
    np.testing.assert_allclose(_np(out["mel_out"]), _np(ref["mel_out"]), atol=1e-4)


def test_predictor_grad_gradients_match_jax():
    """A weighted sum of mel_out, dur, pitch_pred and energy_pred: every
    parameter's gradient, the straight-through mixes scaling what reaches
    the encoder, the speaker embedding and the RefEncoder through the
    predictors."""
    jm, params, tm = models("rel_fft", "conv", seed=8, predictor_grad=0.1, **EXTRA)
    tokens, mel2ph, f0, uv = batch(9)
    extra = _extras(10)
    rng = np.random.RandomState(11)
    w = {k: rng.randn(*s).astype(np.float32) for k, s in
         (("mel_out", (B, TM, 80)), ("dur", (B, TT)), ("pitch_pred", (B, TM, 2)), ("energy_pred", (B, TM)))}

    def jloss(p):
        out = jm.apply({"params": p}, *(jnp.asarray(a) for a in (tokens, mel2ph)), f0=jnp.asarray(f0),
                       uv=jnp.asarray(uv), **{k: jnp.asarray(v) for k, v in extra.items()})
        return sum(jnp.sum(out[k] * w[k]) for k in w)

    grads = jax.device_get(jax.jit(jax.grad(jloss))(params))
    out = tm(torch.tensor(tokens), torch.tensor(mel2ph), f0=torch.tensor(f0), uv=torch.tensor(uv),
             **{k: torch.tensor(v) for k, v in extra.items()})
    sum(torch.sum(out[k] * torch.tensor(w[k])) for k in w).backward()
    ref = jax_params_to_state(tm, grads)
    named = dict(tm.named_parameters())
    assert set(named) == set(ref)
    top = max(np.abs(np.asarray(g)).max() for g in ref.values())
    for name, g in ref.items():
        got = named[name].grad
        got = np.zeros_like(np.asarray(g)) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-3, atol=1e-6 * top, err_msg=name)
    # the mixing is live: the encoder's embedding gets far less than it would at 1.0
    assert 0 < np.abs(named["encoder.emb.weight"].grad.numpy()).max()


def test_bert_encoder_scaffold_matches_jax():
    rng = np.random.RandomState(12)
    x = rng.randn(B, TT, 32).astype(np.float32)
    x[1, 6:] = 0  # padding frames, found by |x| = 0
    jm = JBertEncoderScaffold(num_chars=11, hidden_size=32, num_layers=2)
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.asarray(x))["params"], jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)
    h, logits = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))
    tm = load_jax_params(BertEncoderScaffold(11, 32, num_layers=2), params).eval()
    with torch.no_grad():
        th, tl = tm(torch.tensor(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=1e-4)
    assert not th[1, 6:].any()
