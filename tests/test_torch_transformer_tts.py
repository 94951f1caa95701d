"""Port parity of TransformerTTS (dicttts_tpu_torch.models.transformer_tts)
against the JAX model, on the CPU: the teacher-forced pass, the cached
decode against the JAX scan, the cached decode against the port's own
teacher-forced pass on the frames it produced, and the prenet's dropout
at inference.

Both sides get the same seeded random parameters (a flax tree loaded by
``convert.transformer_tts_state``); the prenet's dropout masks cannot
match JAX's keys, so parity runs at ``prenet_dropout=0`` (as
tests/test_transformer_tts.py does for the JAX model alone), and the
dropout itself is checked by its keep rate. f32 on the CPU; the JAX side
under ``jax.jit``. Tolerances: atol 1e-4 on the teacher-forced outputs and
the decode's frames (values of O(1); the decode feeds each frame back, 24
steps); the stop decisions (``out_mask``) equal; the decode against the
port's teacher-forced pass rtol 2e-4 / atol 2e-5, the JAX test's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models.transformer_tts import TransformerTTS as JTransformerTTS
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models.transformer_tts import TransformerTTS

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

KW = dict(vocab_size=30, hidden_size=32, enc_layers=2, dec_layers=2, num_heads=2,
          enc_ffn_kernel_size=3, dec_ffn_kernel_size=3, prenet_hidden_size=16, mel_bins=8,
          dropout=0.0, num_spk=3)
TXT = np.array([[4, 7, 9, 2, 11, 0], [5, 3, 8, 0, 0, 0]], np.int32)
SPK = np.array([1, 2], np.int32)
T_DEC = 24


@pytest.fixture(scope="module")
def models():
    jm = JTransformerTTS(**KW, prenet_dropout=0.0)
    mels = np.zeros((2, 10, 8), np.float32)
    shapes = jax.eval_shape(lambda r: jm.init({"params": r, "dropout": r}, jnp.asarray(TXT),
                                              jnp.asarray(mels), jnp.asarray(SPK))["params"],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)
    # a stop column (drawn from seeds 104 and 100) whose logits cross 0 after the first frames
    stop = [np.random.RandomState(s).randn(32).astype(np.float32) * 0.3 for s in (104, 100)]
    params["project_out"]["kernel"][:, -1] = stop[0] + 0.25 * stop[1]
    tm = load_jax_params(TransformerTTS(**KW, prenet_dropout=0.0), params).eval()
    return jm, params, tm


def _mels(seed, lengths=(12, 9)):
    rng = np.random.RandomState(seed)
    mels = (rng.randn(2, max(lengths), 8) * 0.7 - 2).astype(np.float32)
    for b, n in enumerate(lengths):
        mels[b, n:] = 0
    return mels


def test_teacher_forced_pass_matches_jax(models):
    jm, params, tm = models
    mels = _mels(2)
    ref = jax.jit(lambda p, t, m, s: jm.apply({"params": p}, t, m, s))(
        params, jnp.asarray(TXT), jnp.asarray(mels), jnp.asarray(SPK))
    with torch.no_grad():
        out = tm(torch.tensor(TXT), torch.tensor(mels), torch.tensor(SPK))
    for key in ("mel_out", "stop_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, err_msg=key)
    for got, want in zip(out["attn"], ref["attn"], strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cached_decode_matches_the_jax_scan(models):
    jm, params, tm = models
    ref = jax.jit(lambda p, t, s: jm.apply({"params": p}, t, T_DEC, s, method=JTransformerTTS.infer,
                                           rngs={"sample": jax.random.PRNGKey(3)}))(
        params, jnp.asarray(TXT), jnp.asarray(SPK))
    out = tm.infer(torch.tensor(TXT), T_DEC, torch.tensor(SPK))
    np.testing.assert_allclose(out["mel_raw"].numpy(), np.asarray(ref["mel_raw"]), atol=1e-4)
    np.testing.assert_allclose(out["stop_logits"].numpy(), np.asarray(ref["stop_logits"]), atol=1e-4)
    np.testing.assert_array_equal(out["out_mask"].numpy(), np.asarray(ref["out_mask"]))
    np.testing.assert_allclose(out["mel_out"].numpy(), np.asarray(ref["mel_out"]), atol=1e-4)
    assert out["mel_raw"].shape == (2, T_DEC, 8) and out["mel_raw"].std() > 0
    stops = out["out_mask"].sum(1).numpy()
    assert (stops > 0).all() and (stops < T_DEC).all(), stops  # each row stops after its first frames


def test_cached_decode_matches_its_own_teacher_forced_pass(models):
    _, _, tm = models
    dec = tm.infer(torch.tensor(TXT), T_DEC, torch.tensor(SPK))
    with torch.no_grad():
        tf = tm(torch.tensor(TXT), dec["mel_raw"], torch.tensor(SPK))
    np.testing.assert_allclose(tf["mel_out"].numpy(), dec["mel_raw"].numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tf["stop_logits"].numpy(), dec["stop_logits"].numpy(), rtol=2e-4, atol=2e-5)


def test_prenet_dropout_stays_on_at_inference(models):
    _, params, _ = models
    tm = load_jax_params(TransformerTTS(**KW, prenet_dropout=0.5), params).eval()
    seen = []
    tm.prenet_fc2.register_forward_hook(lambda m, args, out: seen.append(args[0].detach().clone()))
    x = torch.tensor(np.random.RandomState(5).randn(64, 8).astype(np.float32))
    tm._prenet(x, torch.Generator().manual_seed(6), torch.ones(64, 1))
    with torch.no_grad():
        h = torch.relu(tm.prenet_fc1(x))
    live = h > 0
    kept = seen[0][live] != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.06, float(kept.float().mean())  # ~560 draws
    torch.testing.assert_close(seen[0][live][kept], 2 * h[live][kept])  # kept values scaled 1/(1-p)
    run = [tm.infer(torch.tensor(TXT), 6, generator=torch.Generator().manual_seed(s))["mel_raw"]
           for s in (7, 7, 8)]
    assert torch.equal(run[0], run[1]) and not torch.allclose(run[0], run[2])
    with pytest.raises(ValueError, match="Generator"):
        tm.infer(torch.tensor(TXT), 2)
