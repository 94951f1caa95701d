"""The port's task on the provider's batches (dicttts_tpu_torch.train.tasks):
``to_device`` takes a real provider batch (its ``_meta`` passes through,
the int16/f16 transfer dtypes are upcast), ``prepare_batch`` resolves a
frame-ref batch from the frame cache as the JAX task's ``prepare_batch``
does, and a train step on a frame-ref batch equals the step on the same
batch streamed, bit for bit, losses and every gradient, with a sentence
pad row (item 0, length 0) that must get zero mels. Batches come from the
repo's valid split (.prod_corpus/binary); the bank is random."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask
from dicttts_tpu_torch.config import CONFIG_ROOT, load_config
from dicttts_tpu_torch.data.datasets import TTSBatchProvider, TTSBinaryDataset
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "..", ".prod_corpus", "binary")
RECIPE = os.path.join(CONFIG_ROOT, "datasets", "biaobei", "dict_tts.yaml")
V, E = 8000, 16
SMALL = dict(hidden_size=16, dict_embed_dim=E, latent_size=4, fvae_enc_dec_hidden=16,
             fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8, prior_glow_n_blocks=1,
             mel_disc_hidden_size=8, dur_predictor_layers=2, enc_ffn_kernel_size=3,
             word_size=V + 1, value_embedding_size=168,
             # batches of 4 (the last padded from 2), the 256 and 512 buckets
             max_sentences=4, sentence_buckets=[4], max_frames=512, mel_buckets=[256, 512])


def _cfg(**over):
    return {**load_config(RECIPE, save=False), "binary_data_dir": CORPUS, **SMALL, **over}


def _bank(seed=0, L=8, P=6):
    rng = np.random.RandomState(seed)
    return {"keys": torch.tensor(rng.randn(V, L, E), dtype=torch.bfloat16),
            "key_map": (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32),
            "pinyin": rng.randint(1, 160, (V, P)).astype(np.int32),
            "pinyin_map": np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1))}


def _provider(cfg, frame_refs):
    return TTSBatchProvider(TTSBinaryDataset(CORPUS, "valid", cfg, "dict"), cfg, shuffle=False,
                            emit_frame_refs=frame_refs)


def test_to_device_takes_a_provider_batch():
    cfg = _cfg(mel_transfer_f16=True)
    task = DictTTSTask(cfg, _provider(cfg, True), device="cpu", bank=_bank())
    for frame_refs in (True, False):
        batch = next(iter(_provider(cfg, frame_refs).train_batches()))
        got = task.to_device(batch)
        assert got["_meta"] is batch["_meta"] and got["_meta"][0]["item_name"] == "s0018"
        for k, v in batch.items():
            if k == "_meta":
                continue
            want = {np.dtype(np.int16): torch.int32, np.dtype(np.float16): torch.float32}.get(
                v.dtype, torch.from_numpy(v).dtype)
            assert got[k].dtype == want and got[k].device.type == "cpu", k
            np.testing.assert_array_equal(got[k].numpy(), v.astype(got[k].numpy().dtype), err_msg=k)
        assert ("item_idx" in got) == frame_refs and ("mels" in got) != frame_refs


@pytest.mark.parametrize("over", [{}, {"use_pitch_embed": True, "mel_transfer_f16": True}],
                         ids=["recipe", "pitch_f16"])
def test_prepare_batch_matches_the_jax_task(over):
    cfg = _cfg(**over)
    provider = _provider(cfg, True)
    task = DictTTSTask(cfg, provider, device="cpu", bank=_bank())
    task.attach_device_frame_cache()
    host_cache = provider.ds.device_frame_cache(max_frames=cfg["max_frames"])
    jt = JTask(cfg, None)
    state = {"_const_frame_cache": {k: jnp.asarray(v) for k, v in host_cache.items()}}
    for batch in provider.train_batches():
        batch.pop("_meta")
        want = jt.prepare_batch(state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = task.prepare_batch(task.to_device(batch))
        assert set(got) == set(want) and "item_idx" not in got
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    # the last batch's two pad rows gather item 0, whose frames are not zero
    assert batch["item_idx"][-1] == 0 and batch["mel_lengths"][-1] == 0
    assert np.abs(host_cache["mels"][0]).max() > 0
    assert not got["mels"][-2:].any() and not got["mel2word"][-2:].any()


def test_frame_ref_step_equals_the_streamed_step():
    cfg = _cfg(dropout=0.1)
    bank = _bank(1)
    streamed, refs = (list(_provider(cfg, r).train_batches()) for r in (False, True))
    assert len(streamed) == len(refs) == 5 and refs[-1]["mel_lengths"][-1] == 0  # a pad row
    tasks = []
    for frame_refs in (False, True):
        task = DictTTSTask(cfg, _provider(cfg, frame_refs), device="cpu", bank=bank)
        task.build_state(0)
        task.attach_device_frame_cache()
        tasks.append(task)
    for i in (0, len(refs) - 1):
        out = []
        for task, batch in zip(tasks, (streamed[i], refs[i])):
            b = {k: v for k, v in batch.items() if k != "_meta"}
            m = task.train_step(task.to_device(b), torch.Generator().manual_seed(i))
            grads = [p.grad.clone() for p in (*task.model.parameters(), *task.disc.parameters())]
            out.append(({k: v.item() for k, v in m.items()}, grads))
        (m_s, g_s), (m_r, g_r) = out
        assert m_s == m_r, (i, m_s, m_r)
        assert all(torch.equal(a, b) for a, b in zip(g_s, g_r)), i
    for a, b in zip(tasks[0].model.state_dict().values(), tasks[1].model.state_dict().values()):
        assert torch.equal(a, b)


def test_frame_ref_batches_need_the_cache():
    cfg = _cfg()
    task = DictTTSTask(cfg, None, device="cpu", bank=_bank())
    batch = next(iter(_provider(cfg, True).train_batches()))
    with pytest.raises(ValueError, match="frame cache"):
        task.prepare_batch(task.to_device(batch))
    with pytest.raises(ValueError, match="device_frame_cache"):
        task.attach_device_frame_cache()
    with pytest.raises(ValueError, match="device_bank"):
        DictTTSTask(cfg, object(), device="cpu")
