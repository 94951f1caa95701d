"""Port parity of training on per-utterance gathered dict banks
(``use_device_dict_bank: false``): the dataset's ``_dict_bank`` and the
collater's gathered branch against the JAX package's, and the task's
gathered branch against the JAX task.

- Items and batches of the repo's valid split (.prod_corpus/binary), with
  its dict_embed and with a small dict_embed whose values differ from its
  keys, must equal the JAX provider's exactly, array for array and dtype
  for dtype, with the gloss and pinyin axes bucketed (32 and 8, or
  gloss_buckets / pinyin_buckets).
- One generator and discriminator loss and every gradient leaf from the
  same state on a gathered batch, eager S2PA on both sides, at the
  tolerances of tests/test_torch_train_task.py: losses rtol 1e-5 /
  atol 1e-6, gradients rtol 1e-3 / atol 1e-6 of the largest.
- The JAX rule for which bank the task reads, and ``run.main`` training
  and validating on gathered banks, with no device bank held.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.config import load_config
from dicttts_tpu.data import datasets as jdata
from dicttts_tpu.models import discriminator as jdisc
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask
from dicttts_tpu.utils import indexed_dataset as jidx
from dicttts_tpu_torch import run
from dicttts_tpu_torch.config import CONFIG_ROOT
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params
from dicttts_tpu_torch.data import datasets as tdata
from dicttts_tpu_torch.data.providers import SyntheticDictTTSProvider
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORPUS = os.path.join(ROOT, ".prod_corpus", "binary")
JAX_RECIPE = os.path.join(ROOT, "dicttts_tpu", "configs", "datasets", "biaobei", "dict_tts.yaml")
PORT_RECIPE = os.path.join(CONFIG_ROOT, "datasets", "biaobei", "dict_tts.yaml")
E = 8  # the small dict_embed's width


def _cfg(data_dir=CORPUS, **over):
    return {**load_config(JAX_RECIPE, save=False), "binary_data_dir": data_dir,
            "use_device_dict_bank": False, **over}


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    """The valid split as train/valid/test, its vocabularies, and a small
    dict_embed (width 8) for every word id whose values differ from its keys."""
    root = tmp_path_factory.mktemp("gathered_corpus")
    for f in ("word_set.json", "phone_set.json", "pinyin_encoder.pkl", "spk_map.json"):
        shutil.copy(os.path.join(CORPUS, f), root)
    for split in ("train", "valid", "test"):
        for ext in (".data", ".idx", "_lengths.npy"):
            shutil.copy(os.path.join(CORPUS, "valid" + ext), root / (split + ext))
    with open(os.path.join(CORPUS, "pinyin_encoder.pkl"), "rb") as f:
        pinyin = pickle.load(f)
    rng = np.random.RandomState(0)
    with jidx.IndexedDatasetBuilder(str(root / "dict_embed")) as b:
        for i in range(8000):
            n, ns = (40 if i == 7 else rng.randint(1, 12)), rng.randint(1, 4)
            b.add_item({"key": rng.randn(n, E).astype(np.float32),
                        "value": rng.randn(n, E).astype(np.float32),
                        "key_map": np.arange(n) * ns // n + 1,
                        "pinyin": [pinyin[j] for j in rng.randint(2, len(pinyin), 2 * ns)],
                        "pinyin_map": np.repeat(np.arange(1, ns + 1), 2),
                        "tokens_gloss": [f"t{i}"] * n})
    return str(root)


def _assert_same(got, want, where=""):
    if isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.mark.parametrize("bank", ["repo", "distinct_values"])
def test_items_and_batches_match_the_jax_provider(bank, small_corpus):
    data_dir = CORPUS if bank == "repo" else small_corpus
    cfg = _cfg(data_dir, **({} if bank == "repo" else {"max_sentences": 5, "gloss_buckets": [16, 48],
                                                        "pinyin_buckets": [4, 12]}))
    want = jdata.TTSBinaryDataset(data_dir, "valid", cfg, "dict")
    got = tdata.TTSBinaryDataset(data_dir, "valid", cfg, "dict")
    items = [got[i] for i in range(len(got))]
    for i, item in enumerate(items):
        _assert_same(item, want[i], f"item {i}")
        n = len(item["word_tokens"])
        assert item["keys"].shape[0] == item["key_map"].shape[0] == n
        assert not item["keys"][[0, -1]].any() and (item["key_map"][[0, -1]] == 1).all()
    if bank == "distinct_values":
        assert not np.array_equal(items[0]["keys"], items[0]["values"])
    batches = [list(mod.TTSBatchProvider(ds, cfg, shuffle=False).val_batches())
               for mod, ds in ((tdata, got), (jdata, want))]
    assert len(batches[0]) == len(batches[1]) > 0
    for i, (g, w) in enumerate(zip(*batches)):
        _assert_same(g, w, f"batch {i}")
        B, Tw = g["word_tokens"].shape
        L, P = g["keys"].shape[2], g["pinyin"].shape[2]
        assert g["keys"].shape == g["values"].shape and g["key_map"].shape == (B, Tw, L)
        if bank == "repo":
            assert g["keys"].shape[-1] == 768 and L % 32 == 0 and P % 8 == 0
        else:
            assert L in (16, 48) and P in (4, 12)


def _batch(rng, B=2, Tw=8, T=96, L=6, P=4, V=40):
    """A collater-format gathered batch (BOS, words of 6-14 frames, EOS)."""
    wt = np.zeros((B, Tw), np.int32)
    m2w = np.zeros((B, T), np.int32)
    wl = np.zeros(B, np.int32)
    for b, n_frames in enumerate((T, 70)):
        f = w = 0
        while f < n_frames and w < Tw:
            d = min(rng.randint(6, 15), n_frames - f)
            m2w[b, f:f + d] = w + 1
            f, w = f + d, w + 1
        wt[b, :w] = rng.randint(3, V, w)
        wl[b] = w
    real = (wt > 0)[:, :, None]
    km = (rng.randint(0, 3, (B, Tw, L)) + (np.arange(L) == 0)) * real
    return {
        "word_tokens": wt, "mel2word": m2w, "word_lengths": wl,
        "mel_lengths": (m2w > 0).sum(1).astype(np.int32),
        "mels": ((rng.randn(B, T, 80) * 0.5 - 2) * (m2w > 0)[:, :, None]).astype(np.float32),
        "pron_modified": (np.where(rng.rand(B, Tw) < 0.2, 1, 0) * (wt > 0)).astype(np.int32),
        "keys": (rng.randn(B, Tw, L, E) * real[..., None]).astype(np.float32),
        "values": (rng.randn(B, Tw, L, E) * real[..., None]).astype(np.float32),
        "key_map": km.astype(np.int32),
        "pinyin": (rng.randint(1, 30, (B, Tw, P)) * real).astype(np.int32),
        "pinyin_map": (np.tile(np.array([1, 1, 2, 2], np.int32), (B, Tw, 1)) * real).astype(np.int32),
    }


CFG = dict(word_size=40, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dropout=0.0,
           predictor_dropout=0.0, value_embedding_size=30, dict_embed_dim=E,
           dur_predictor_layers=2, dur_predictor_kernel=3, latent_size=4, fvae_enc_dec_hidden=16,
           fvae_kernel_size=3, fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8,
           glow_kernel_size=3, prior_glow_n_blocks=1, mel_disc_hidden_size=8,
           use_device_dict_bank=False)


class _NoDropoutBlock(jdisc.Disc2DBlockStack):
    dropout: float = 0.0


def _starts(u, lengths, T):
    """The JAX discriminator's crop starts for uniforms u (float32 math)."""
    max_len = int(np.max(lengths))
    return np.array([min(max(int(np.floor(np.float32(ui) * np.float32(max(max_len - w, 0) + 1))), 0),
                         max(T - w, 0)) for ui, w in zip(u, (32, 64, 128))], np.int64)


def _compare_grads(module, jax_grads):
    ref = jax_params_to_state(module, jax.device_get(jax_grads))
    named = dict(module.named_parameters())
    assert set(named) == set(ref)
    top = max(np.abs(np.asarray(g)).max() for g in ref.values())
    for name, g in ref.items():
        assert named[name].grad is not None, name
        np.testing.assert_allclose(named[name].grad.numpy(), np.asarray(g), rtol=1e-3, atol=1e-6 * top,
                                   err_msg=name)


def test_gathered_train_step_losses_and_gradients_match_jax(monkeypatch):
    rng = np.random.RandomState(1)
    batch = _batch(rng)
    jt = JTask(dict(CFG), None)
    shapes = jax.eval_shape(lambda r: {k: v for k, v in jt.build_state(r).items()
                                       if k.startswith("params")}, jax.random.PRNGKey(0))
    prng = np.random.RandomState(2)
    params_g, params_d = (jax.tree.map(lambda s: (prng.randn(*s.shape) * sc).astype(np.float32), shapes[k])
                          for k, sc in (("params_g", 0.2), ("params_d", 0.05)))
    T = batch["mels"].shape[1]
    eps = rng.randn(2, T // 4, CFG["latent_size"]).astype(np.float32)
    u = np.array([0.3, 0.8, 0.45], np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(u))
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", _NoDropoutBlock)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    (loss_g, (g_losses, out)), grads_g = jax.jit(jax.value_and_grad(
        lambda pg, pd, bt, k: jt._gen_losses(pg, pd, bt, k, True, 1.0), has_aux=True))(
        params_g, params_d, jbatch, key)
    (loss_d, d_losses), grads_d = jax.jit(jax.value_and_grad(jt._disc_losses, has_aux=True))(
        params_d, out["mel_out"], jbatch["mels"], jbatch["mel_lengths"], key)

    task = DictTTSTask({**CFG, "disc_dropout": 0.0}, device="cpu")
    assert task.bank is None and not task.use_device_bank
    task.build_state(0)
    load_jax_params(task.model, params_g)
    load_jax_params(task.disc, params_d)
    tbatch = task.to_device(batch)
    starts = torch.tensor(_starts(u, batch["mel_lengths"], T))
    task.model.train()
    task.disc.train()
    t_loss_g, t_losses, t_out = task._gen_losses(tbatch, None, True, 1.0, torch.tensor(eps), starts)
    t_loss_g.backward()
    t_loss_d, t_d_losses = task._disc_losses(t_out["mel_out"].detach(), tbatch["mels"],
                                             tbatch["mel_lengths"], None, starts)
    t_loss_d.backward()
    assert set(t_losses) == set(g_losses)
    for name, ref in [*g_losses.items(), *d_losses.items(), ("total", loss_g), ("disc", loss_d)]:
        got = {**t_losses, **t_d_losses, "total": t_loss_g, "disc": t_loss_d}[name]
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-6, err_msg=name)
    _compare_grads(task.model, grads_g)
    _compare_grads(task.disc, grads_d)
    # the whole step updates on a gathered batch, and K3 serves eval only
    task.cfg["use_pallas_s2pa"] = True
    m = task.train_step(tbatch, torch.Generator().manual_seed(0))
    assert task.step == 1 and "grad_norm_g" in m and all(torch.isfinite(v) for v in m.values())
    v = task.val_step(tbatch, torch.Generator().manual_seed(1))
    assert all(torch.isfinite(x) for x in v.values())


def test_which_bank_the_task_reads():
    rng = np.random.RandomState(3)
    batch = _batch(rng)
    V, L, P = 40, 6, 4
    bank = {"keys": rng.randn(V, L, E).astype(np.float32),
            "key_map": np.ones((V, L), np.int32), "pinyin": rng.randint(1, 30, (V, P)).astype(np.int32),
            "pinyin_map": np.tile(np.array([1, 1, 2, 2], np.int32), (V, 1))}
    base = {**CFG, "use_device_dict_bank": True}
    fused = DictTTSTask(base, device="cpu", bank=bank)
    neither = DictTTSTask(base, device="cpu")  # no data, no bank: gathered, as the inferencer builds it
    assert fused.use_device_bank and neither.bank is None and not neither.use_device_bank
    wt = torch.as_tensor(batch["word_tokens"]).long()
    dm_f = fused._dict_msg({"word_tokens": wt})
    assert dm_f.keys.shape == (V, L, E)
    # the device bank's rows, gathered into the batch, give the same outputs
    # on the gathered route as the fused kernels give on the device bank
    b = fused.bank
    gathered = {"keys": b["keys"][wt], "values": b["keys"][wt], "key_map": b["key_map"][wt],
                "pinyin": b["pinyin"][wt], "pinyin_map": b["pinyin_map"][wt]}
    dm_g = neither._dict_msg({"word_tokens": wt, **gathered})
    for a, g in zip(dm_f[2:], dm_g[2:]):
        assert torch.equal(a, g)
    for task in (fused, neither):
        task.build_state(4)
    neither.model.load_state_dict(fused.model.state_dict())
    tb = fused.to_device({k: batch[k] for k in ("word_tokens", "pron_modified")})
    outs = [t.test_step(bt, noise=torch.zeros(2, 1548 // 4, 4))
            for t, bt in ((fused, tb), (neither, {**tb, **gathered}))]
    torch.testing.assert_close(outs[0]["mel_out"], outs[1]["mel_out"], rtol=0, atol=1e-5)
    # s2pa_bank_fused off (ported now, tests/test_torch_dict_tts_options.py):
    # the task gathers the device bank's rows by word id itself
    unfused = DictTTSTask({**base, "s2pa_bank_fused": False}, device="cpu", bank=bank)
    assert unfused.use_device_bank and not unfused.bank_fused
    for a, g in zip(unfused._dict_msg({"word_tokens": wt}), dm_g):
        assert torch.equal(a, g)
    unfused.build_state(4)
    unfused.model.load_state_dict(fused.model.state_dict())
    out = unfused.test_step(tb, noise=torch.zeros(2, 1548 // 4, 4))
    torch.testing.assert_close(out["mel_out"], outs[1]["mel_out"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="gathered bank"):
        neither._dict_msg({"word_tokens": wt})
    with pytest.raises(ValueError, match="use_device_dict_bank is false"):
        DictTTSTask(CFG, device="cpu", bank=bank)
    provider = SyntheticDictTTSProvider(word_vocab=40, embed_dim=E, pinyin_vocab=30)
    task = DictTTSTask(CFG, provider, device="cpu")
    task.build_state(5)
    m = task.train_step(task.to_device(next(provider.train_batches())), torch.Generator().manual_seed(0))
    assert task.bank is None and bool(torch.isfinite(m["total_loss"]))


def test_run_main_trains_on_gathered_banks(small_corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    hp = (f"binary_data_dir={small_corpus},use_device_dict_bank=False,max_updates=2,val_check_interval=2,"
          "num_sanity_val_steps=0,hidden_size=16,dict_embed_dim=8,latent_size=4,fvae_enc_dec_hidden=16,"
          "fvae_enc_n_layers=1,fvae_dec_n_layers=1,prior_glow_hidden=8,prior_glow_n_blocks=1,"
          "mel_disc_hidden_size=8,dur_predictor_layers=2,enc_ffn_kernel_size=3,max_frames=256,"
          "mel_buckets=[128 256],max_sentences=5")
    seen = []
    to_device = DictTTSTask.to_device

    def spy(self, batch):
        seen.append({k: np.shape(v) for k, v in batch.items() if k in ("keys", "values", "key_map")})
        return to_device(self, batch)

    monkeypatch.setattr(DictTTSTask, "to_device", spy)
    trainer, task = run.main(["--config", PORT_RECIPE, "--exp_name", "gathered", "--device", "cpu",
                              "--hparams", hp])
    assert trainer.global_step == 2 and task.bank is None and "bank" not in task.uploads
    assert seen and all(s["keys"][-1] == E and s["keys"] == s["values"] for s in seen)
    assert all(np.isfinite(float(v)) for v in trainer.metrics.values())
    assert all(np.isfinite(v) for v in trainer.val_metrics.values())
