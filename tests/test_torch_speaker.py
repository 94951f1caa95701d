"""Port parity of the speaker encoder and speaker embeddings
(dicttts_tpu_torch.models.speaker_encoder, ops/speaker.py, and the
binarizer's ``with_spk_embed`` items) against the JAX package's, on the
CPU.

- ``spectral_speaker_stats`` and ``resemblyzer_mel`` (numpy and scipy on
  both sides) exactly;
- from one Resemblyzer-format ``state_dict`` (seeded, 3 LSTM layers at
  width 64; the JAX side through its ``convert_resemblyzer_state``): the
  GE2E forward and ``embed_utterance`` (windows of a long utterance, and a
  short one padded to a window) within atol 1e-5 on unit-norm embeddings,
  the LSTM's summation orders apart; ``ge2e_loss`` rtol 1e-5;
- ``speaker_embed`` through a checkpoint file and without one (on 40-bin
  mels, the JAX package's ``ge2e_embed``); a checkpoint that cannot be
  read raises, and ``load_resemblyzer`` runs on the card unless asked
  for the CPU;
- the toy corpus of tests/test_torch_binarizer.py binarized by both
  packages with ``with_spk_embed`` and that checkpoint: every item's
  ``spk_embed`` within 1e-5 of the JAX binarizer's (the same wavs through
  Resemblyzer's front end; the f32 LSTMs sum in different orders).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_binarizer as TB  # noqa: E402

from dicttts_tpu.models import speaker_encoder as jse  # noqa: E402
from dicttts_tpu.ops import speaker as jsp  # noqa: E402
from dicttts_tpu.text import binarizer as jbin  # noqa: E402
from dicttts_tpu_torch.models import speaker_encoder as tse  # noqa: E402
from dicttts_tpu_torch.ops import speaker as tsp  # noqa: E402
from dicttts_tpu_torch.text import binarizer as tbin  # noqa: E402
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

H, E, LAYERS = 64, 48, 3


def resemblyzer_state(seed):
    """A VoiceEncoder ``state_dict`` in Resemblyzer's layout (both LSTM
    biases), as numpy arrays."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k in range(LAYERS):
        n_in = 40 if k == 0 else H
        sd[f"lstm.weight_ih_l{k}"] = rng.randn(4 * H, n_in) * 0.15
        sd[f"lstm.weight_hh_l{k}"] = rng.randn(4 * H, H) * 0.15
        sd[f"lstm.bias_ih_l{k}"] = rng.randn(4 * H) * 0.1
        sd[f"lstm.bias_hh_l{k}"] = rng.randn(4 * H) * 0.1
    sd["linear.weight"] = rng.randn(E, H) * 0.2
    sd["linear.bias"] = rng.randn(E) * 0.1
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ge2e") / "ge2e.pt")
    torch.save({"model_state": {k: torch.tensor(v) for k, v in resemblyzer_state(1).items()}}, path)
    return path


def test_stats_and_resemblyzer_mel_match_jax_exactly():
    rng = np.random.RandomState(0)
    mel = (rng.randn(90, 80) - 3).astype(np.float32)
    f0 = np.where(rng.rand(90) < 0.7, rng.uniform(90, 300, 90), 0).astype(np.float32)
    for args in ((mel, None), (mel, f0), (mel[:1], f0[:1]), (mel, np.zeros(90, np.float32))):
        got, want = tsp.spectral_speaker_stats(*args), jsp.spectral_speaker_stats(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    wav, _ = TB.glide(rng, 1.3, 100, 220)
    for sr in (22050, 16000, 24000):
        got, want = tsp.resemblyzer_mel(wav, sr), jsp.resemblyzer_mel(wav, sr)
        assert got.dtype == want.dtype and got.shape[1] == 40 and np.array_equal(got, want)


def test_ge2e_forward_embedding_and_loss_match_jax():
    sd = resemblyzer_state(2)
    params = jse.convert_resemblyzer_state(sd)
    tm = tse.GE2ESpeakerEncoder.from_state_dict(sd).eval()
    assert (tm.lstm.num_layers, tm.lstm.hidden_size, tm.linear.out_features) == (LAYERS, H, E)
    rng = np.random.RandomState(3)
    mels = np.abs(rng.randn(3, 50, 40)).astype(np.float32)
    want = jax.jit(lambda p, m: jse.GE2ESpeakerEncoder(LAYERS, H, E).apply({"params": p}, m))(
        params, jnp.asarray(mels))
    with torch.no_grad():
        got = tm(torch.tensor(mels)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    for T in (430, 90):  # several windows with a flush last one; one padded window
        mel = np.abs(rng.randn(T, 40)).astype(np.float32)
        np.testing.assert_allclose(tse.embed_utterance(tm, mel), jse.embed_utterance(params, mel), atol=1e-5)
    assert len(tse.partial_windows(np.zeros((430, 40)))) == 5
    emb = rng.randn(3, 4, 16).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    for w, b in ((10.0, -5.0), (-1.0, 0.5)):  # a negative scale is floored at 1e-6 on both sides
        want = float(jse.ge2e_loss(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(b)))
        got = float(tse.ge2e_loss(torch.tensor(emb), torch.tensor(w), torch.tensor(b)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_speaker_embed_through_a_checkpoint_and_without(ckpt):
    rng = np.random.RandomState(4)
    wav, _ = TB.glide(rng, 2.1, 110, 180)
    mel = (rng.randn(180, 80) - 4).astype(np.float32)
    f0 = rng.uniform(100, 200, 180).astype(np.float32)
    cfg = {"spk_encoder_ckpt": ckpt}
    np.testing.assert_allclose(tsp.speaker_embed(mel, f0, cfg, wav=wav, sr=22050, device="cpu"),
                               jsp.speaker_embed(mel, f0, cfg, wav=wav, sr=22050), atol=1e-5)
    np.testing.assert_allclose(tsp.speaker_embed(mel, f0, cfg, device="cpu"),  # the corpus mel, cut to 40
                               jsp.speaker_embed(mel, f0, cfg), atol=1e-5)
    assert np.array_equal(tsp.speaker_embed(mel, f0, {}), jsp.speaker_embed(mel, f0, {}))
    # one utterance of 40-bin mels from the checkpoint: the JAX package's ge2e_embed
    np.testing.assert_allclose(tsp.speaker_embed(mel[:, :40], f0, cfg, device="cpu"),
                               jse.ge2e_embed(mel[:, :40], ckpt), atol=1e-5)
    m = tse.load_resemblyzer(ckpt, "cpu")
    assert not m.training and next(m.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():  # the card is the default: asked for and absent, it raises
        with pytest.raises(RuntimeError, match="cuda"):
            tse.load_resemblyzer(ckpt)
    for bad in (ckpt + ".missing", __file__):  # no file, not a torch file: both raise
        with pytest.raises(Exception):
            tsp.speaker_embed(mel, f0, {"spk_encoder_ckpt": bad}, device="cpu")


def test_binarizer_spk_embed_items_match_jax(tmp_path, ckpt):
    raw, dict_path = TB._toy_raw(tmp_path)
    dirs = {}
    for name, (pre, binz) in {"port": (tbin.BiaobeiPreAlign, lambda c: tbin.ZhBinarizer(c, device="cpu")),
                              "jax": (jbin.BiaobeiPreAlign, jbin.ZhBinarizer)}.items():
        cfg = TB._toy_cfg(tmp_path, name, raw, dict_path, with_spk_embed=True, spk_encoder_ckpt=ckpt,
                          with_f0cwt=False)
        pre(cfg).process()
        binz(cfg).process()
        dirs[name] = cfg["binary_data_dir"]
    n = 0
    for split in ("test", "valid", "train"):
        got, want = IndexedDataset(os.path.join(dirs["port"], split)), IndexedDataset(os.path.join(dirs["jax"], split))
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            g, w = got[i]["spk_embed"], want[i]["spk_embed"]
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (E,)
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=f"{split}[{i}]")
            n += 1
    assert n == len(TB.TOY_TEXTS)
