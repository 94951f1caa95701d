"""The port's serving export (``dicttts_tpu_torch/serving_export.py``), as
tests/test_serving_export.py holds the JAX one: ``torch.export`` artifacts
round-trip on the CPU and equal the live ``test_step`` given the same
noise (atol 1e-5, mel2word exact); the bucket choice and the zero fit;
mel2word and pinyin_pred equal the JAX package's ``ExportedTTS`` on the
same weights (converted from the JAX state); with ``use_pallas_s2pa`` the
graph holds K3 as the operator ``dicttts_tpu_torch::s2pa_fused`` once and
equals the plain export; a HiFi-GAN generator exports with it; and the
command line exports the newest checkpoint of an experiment.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from dicttts_tpu.serving_export import ExportedTTS as JExported
from dicttts_tpu.serving_export import export_tts as jexport
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask
from dicttts_tpu_torch.config import CONFIG_ROOT
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.serving_export import ExportedTTS, export_tts, main
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.utils.checkpoint import save_checkpoint
from dicttts_tpu_torch.vocoders.hifigan import spec2wav

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

TINY = {
    "word_size": 20, "hidden_size": 16, "num_heads": 2, "enc_ffn_kernel_size": 3,
    "dropout": 0.0, "value_embedding_size": 12, "dict_embed_dim": 8,
    "latent_size": 4, "fvae_enc_dec_hidden": 16, "fvae_enc_n_layers": 1,
    "fvae_dec_n_layers": 1, "prior_glow_hidden": 8, "prior_glow_n_blocks": 1,
    "mel_disc_hidden_size": 8, "max_frames": 64, "frames_multiple": 4,
    "audio_num_mel_bins": 80,
}
PORT = {**TINY, "use_device_dict_bank": False}


def _inputs(B, Tw, L=8, P=4, E=8, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        word_tokens=rng.randint(1, 20, (B, Tw)).astype(np.int32),
        keys=rng.randn(B, Tw, L, E).astype(np.float32),
        values=rng.randn(B, Tw, L, E).astype(np.float32),
        key_map=(rng.randint(0, 3, (B, Tw, L)) + (np.arange(L) == 0)).astype(np.int32),
        pinyin=rng.randint(1, 12, (B, Tw, P)).astype(np.int32),
        pinyin_map=np.tile([1, 1, 2, 2], (B, Tw, 1)).astype(np.int32),
        pron_modified=np.zeros((B, Tw), np.int32),
    )


@pytest.fixture(scope="module")
def jax_state():
    """Seeded random generator weights in the JAX task's shapes (flax's own
    init, eager or jitted, takes 15-45 s here)."""
    jt = JTask(dict(TINY))
    shapes = jax.eval_shape(lambda r: jt.build_state(r)["params_g"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    return {"params_g": jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.2).astype(np.float32), shapes)}


def _task(jax_state, **cfg):
    """The port's task with the JAX state's generator weights."""
    task = DictTTSTask({**PORT, **cfg}, device="cpu")
    task.build_state(0)
    load_jax_params(task.model, jax.device_get(jax_state["params_g"]))
    return task


@pytest.fixture(scope="module")
def plain(jax_state, tmp_path_factory):
    task = _task(jax_state)
    out = export_tts(PORT, task, buckets=[(2, 8)], gloss_len=8, pinyin_len=4,
                     out_dir=str(tmp_path_factory.mktemp("plain")))
    return task, out, ExportedTTS(out)


def test_export_roundtrip_matches_live(plain):
    task, _, served = plain
    assert served.manifest["device"] == "cpu" and served.manifest["noise_shape"] == [16, 4]
    x = _inputs(2, 8)
    mel, mel2word, pinyin_pred = served(**x, seed=3)
    assert mel.shape == (2, 64, 80) and np.isfinite(mel).all() and pinyin_pred.shape == (2, 8, 2)
    live = task.test_step(task.to_device(x), noise=served.noise(2, 3))
    np.testing.assert_allclose(mel, live["mel_out"].numpy(), atol=1e-5)
    np.testing.assert_array_equal(mel2word, live["mel2word"].numpy())
    np.testing.assert_array_equal(pinyin_pred, live["pinyin_pred"].numpy())
    assert (mel2word > 0).any()


def test_export_matches_the_jax_export(plain, jax_state, tmp_path):
    _, out_dir, served = plain
    jdir = jexport(TINY, jax_state, buckets=[(2, 8)], gloss_len=8, pinyin_len=4,
                   out_dir=str(tmp_path / "jax"))
    x = _inputs(2, 8, seed=1)
    _, m2w, pp = served(**x, seed=0)
    _, jm2w, jpp = JExported(jdir)(**x, seed=0)
    np.testing.assert_array_equal(m2w, jm2w)
    np.testing.assert_array_equal(pp, jpp)
    with open(os.path.join(jdir, "manifest.json")) as f:
        jkeys = set(yaml.safe_load(f))
    with open(os.path.join(out_dir, "manifest.json")) as f:
        assert jkeys <= set(yaml.safe_load(f))


def test_the_k3_graph_holds_the_operator_and_equals_the_plain_export(plain, jax_state, tmp_path):
    _, _, plain_export = plain
    task = _task(jax_state, use_pallas_s2pa=True)
    out_dir = export_tts(PORT, task, buckets=[(2, 8)], gloss_len=8, pinyin_len=4, out_dir=str(tmp_path))
    x = _inputs(2, 8, seed=2)
    k3 = ExportedTTS(out_dir)
    for got, want in zip(k3(**x, seed=5), plain_export(**x, seed=5)):
        np.testing.assert_allclose(got, want, atol=1e-5)
    targets = [str(n.target) for n in k3._fns[(2, 8)].graph.nodes]
    assert targets.count("dicttts_tpu_torch.s2pa_fused.default") == 1
    assert not any("dicttts_tpu_torch" in str(n.target) for n in plain_export._fns[(2, 8)].graph.nodes)


def test_export_bucket_selection_fit_and_vocoder(jax_state, tmp_path):
    task = _task(jax_state)
    vocoder = HifiGanGenerator(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                               upsample_initial_channel=16, resblock_kernel_sizes=(3,)).eval()
    out_dir = export_tts(PORT, task, vocoder=vocoder, buckets=[(1, 8), (4, 16)], gloss_len=8,
                         pinyin_len=4, out_dir=str(tmp_path))
    served = ExportedTTS(out_dir)
    # B=3, Tw=10 -> bucket (4, 16), cut back to B=3
    x = _inputs(3, 10)
    wav, mel, mel2word, _ = served(**x, seed=1)
    assert wav.shape == (3, 64 * 16) and mel.shape[0] == 3 and set(served._fns) == {(4, 16)}
    fitted = {k: np.zeros((4, 16, *v.shape[2:]), v.dtype) for k, v in x.items()}
    for k, v in x.items():
        fitted[k][:3, :10] = v
    live = task.test_step(task.to_device(fitted), noise=served.noise(4, 1))
    np.testing.assert_array_equal(mel2word, live["mel2word"][:3].numpy())
    np.testing.assert_allclose(wav, spec2wav(vocoder, live["mel_out"])[:3].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="no exported bucket"):
        served(**_inputs(8, 8))


def test_the_command_line_exports_the_newest_checkpoint(jax_state, tmp_path, monkeypatch):
    task = _task(jax_state)
    work = tmp_path / "checkpoints" / "tiny"
    work.mkdir(parents=True)
    with open(work / "config.yaml", "w") as f:
        yaml.safe_dump({**TINY, "binary_data_dir": str(tmp_path / "none")}, f)
    save_checkpoint(str(work), 7, task.state_dict())
    monkeypatch.chdir(tmp_path)
    main(["--config", os.path.join(CONFIG_ROOT, "tts", "dict_tts.yaml"), "--exp_name", "tiny",
          "--buckets", "1x8", "--device", "cpu"])
    served = ExportedTTS(str(work / "export"))
    x = _inputs(1, 8, seed=4)
    mel, mel2word, _ = served(**x, seed=2)
    live = task.test_step(task.to_device(x), noise=served.noise(1, 2))
    np.testing.assert_allclose(mel, live["mel_out"].numpy(), atol=1e-5)
    np.testing.assert_array_equal(mel2word, live["mel2word"].numpy())
