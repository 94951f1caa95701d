"""The port's dict bank keeps the dtype it arrives in, and the bank kernels'
slot grouping and cluster plan.

- Intake: ``bank_tensor`` takes tensors and numpy arrays of any dtype,
  including the ``ml_dtypes`` bfloat16 that the JAX package's
  ``device_bank()`` returns (``torch.as_tensor`` refuses it); the training
  task and the server hold such a bank as ``torch.bfloat16``, as the
  recipe trains (``dicttts_tpu/data/datasets.py:93-94``), and train and
  serve on it.
- The port's ``DictEncoder`` bank branch on a bf16 bank against the JAX
  ``DictEncoder``'s fused bank branch (``dicttts_tpu/models/
  dict_encoder.py:183``, ``s2pa_bank_attend`` in interpret mode off the
  TPU): outputs and parameter gradients. Tolerance: rtol 3e-5 / atol 3e-5
  of the largest value of each output, and of the largest gradient of any
  parameter (some leaves, such as the key biases, have a gradient that is
  0 up to rounding). Both sides cast the f32 query to bf16 before the
  kernel and round w * mask, g_ctx and d_logits to bf16 at the same
  places, so they differ by summation order only (3.4e-7 of the largest
  output here); the same encoder on an f32 bank holding the same values
  differs by 4.5e-4 (bf16 rounding), and the test checks that the
  tolerance tells the two apart by a factor of 5.
- ``slot_order`` (the stable sort of the word ids that the bank kernels
  group slots by) on the CPU. The chunks the kernels cut from it, their
  cluster plan and the kernels themselves come from the built kernel
  library and are tested on the card (test_torch_kernels_gpu.py).
- The corpus-like word ids that chip_smoke.py times the bank kernels on
  have the layout of the corpus's training batches.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dicttts_tpu.models import dict_encoder as jde
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params
from dicttts_tpu_torch.models import dict_encoder as tde
from dicttts_tpu_torch.models.dict_tts import DictTTS
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.ops.s2pa_bank import bank_tensor, slot_order
from dicttts_tpu_torch.serve import DictTTSServer, Request
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16


def _np_bank(seed, V=40, L=12, E=32, P=6):
    """A device_bank()-style bank: bf16 keys as numpy ml_dtypes, int32 maps."""
    rng = np.random.RandomState(seed)
    km = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    return {"keys": (rng.randn(V, L, E) * 0.5).astype(BF16), "key_map": km,
            "pinyin": rng.randint(1, 30, (V, P)).astype(np.int32),
            "pinyin_map": np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1))}


@pytest.mark.parametrize("kind", ["numpy_bf16", "numpy_f32", "numpy_int32", "tensor_bf16"])
def test_bank_tensor_keeps_the_dtype(kind):
    x = np.random.RandomState(0).randn(3, 4, 8).astype(np.float32)
    if kind == "numpy_bf16":
        src, want = x.astype(BF16), torch.tensor(x.astype(BF16).astype(np.float32)).bfloat16()
    elif kind == "numpy_f32":
        src, want = x, torch.tensor(x)
    elif kind == "numpy_int32":
        src = (x * 10).astype(np.int32)
        want = torch.tensor(src)
    else:
        want = torch.tensor(x).bfloat16()
        src = want.clone()
    got = bank_tensor(src, "cpu")
    assert got.dtype == want.dtype and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bank_tensor_reads_a_strided_numpy_bf16_view():
    x = np.random.RandomState(1).randn(4, 6, 8).astype(BF16)
    view = x[:, ::2]  # not contiguous
    got = bank_tensor(view, "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), view.astype(np.float32))


# the task's small widths (tests/test_torch_train_task.py)
CFG = dict(word_size=40, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dropout=0.0,
           predictor_dropout=0.0, value_embedding_size=30, dict_embed_dim=32,
           dur_predictor_layers=2, dur_predictor_kernel=3, latent_size=4, fvae_enc_dec_hidden=16,
           fvae_kernel_size=3, fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8,
           glow_kernel_size=3, prior_glow_n_blocks=1, mel_disc_hidden_size=8, disc_dropout=0.0)


def _batch(seed, B=2, Tw=8, T=96):
    rng = np.random.RandomState(seed)
    wt = np.zeros((B, Tw), np.int32)
    m2w = np.zeros((B, T), np.int32)
    wl = np.zeros(B, np.int32)
    for b in range(B):
        f = w = 0
        while f < T and w < Tw:
            d = min(rng.randint(8, 17), T - f)
            m2w[b, f:f + d] = w + 1
            f, w = f + d, w + 1
        wt[b, :w] = rng.randint(3, 40, w)
        wl[b] = w
    mels = (rng.randn(B, T, 80) * 0.5 - 2).astype(np.float32) * (m2w > 0)[:, :, None]
    return {"word_tokens": wt, "pron_modified": np.zeros((B, Tw), np.int32), "mel2word": m2w,
            "mels": mels, "word_lengths": wl, "mel_lengths": (m2w > 0).sum(1).astype(np.int32)}


def test_task_trains_on_a_numpy_bf16_bank():
    bank = _np_bank(0)
    task = DictTTSTask(CFG, bank=bank, device="cpu")
    assert task.bank["keys"].dtype == torch.bfloat16  # not upcast to f32
    np.testing.assert_array_equal(task.bank["keys"].float().numpy(), bank["keys"].astype(np.float32))
    task.build_state(0)
    q_proj = task.model.dict_encoder.S2PA_module.s2pa_attention.q_transform.weight
    before = q_proj.detach().clone()
    m = task.train_step(task.to_device(_batch(1)), torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in m.values())
    # the query reaches the bank only through the bf16 kernel path: its
    # gradient comes back through K2's plain version and the dtype cast
    assert not torch.equal(before, q_proj.detach())


def test_server_serves_from_a_numpy_bf16_bank():
    bank = _np_bank(2)
    acoustic = DictTTS(word_vocab=40, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, pinyin_vocab=30,
                       dict_embed_dim=32, dur_predictor_layers=2, dur_predictor_kernel=3, latent_size=4,
                       fvae_enc_dec_hidden=16, fvae_enc_n_layers=1, fvae_dec_n_layers=1,
                       prior_flow_hidden=8, prior_flow_n_blocks=1)
    vocoder = HifiGanGenerator(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                               upsample_initial_channel=16, resblock_kernel_sizes=(3,))
    server = DictTTSServer(acoustic, vocoder, bank, max_frames=64, device="cpu")
    assert server.bank["keys"].dtype == torch.bfloat16
    np.testing.assert_array_equal(server.bank["keys"].float().numpy(), bank["keys"].astype(np.float32))
    ids = np.array([1, 5, 9, 2], np.int32)
    rows = {k: v[ids] for k, v in bank.items()}  # a gathered request, bf16 rows too
    for req in (Request(ids), Request(ids, None, rows)):
        out = server.acoustic_batch([req], seed=0)
        assert torch.isfinite(out["mel_out"]).all()


V, L, E = 24, 16, 128


def _encoder_data(seed, B=2, T=5, P=4):
    rng = np.random.RandomState(seed)
    bank = (rng.randn(V, L, E) * 0.3).astype(BF16)
    km_bank = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    pin_bank = rng.randint(1, 50, (V, P)).astype(np.int32)
    pm_bank = np.tile(np.array([1, 1, 2, 2], np.int32), (V, 1))
    wt = rng.randint(1, V, (B, T)).astype(np.int32)
    wt[1, 4:] = 0
    return bank, km_bank[wt], pin_bank[wt], pm_bank[wt], wt


def _close(got, ref, name, scale, tol=3e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32), rtol=tol,
                               atol=tol * scale, err_msg=name)


def test_dict_encoder_bf16_bank_matches_jax_fused_branch():
    bank, km, pin, pm, wt = _encoder_data(5)
    jm = jde.DictEncoder(word_vocab=V, hidden_size=16, num_heads=2, dropout=0.0, pinyin_vocab=50)
    jbank = jnp.asarray(bank)
    assert jbank.dtype == jnp.bfloat16
    dm_j = jde.DictMsg(jbank, jbank, jnp.asarray(km), jnp.asarray(pin), jnp.asarray(pm))
    params = jax.eval_shape(lambda r: jm.init(
        {"params": r}, jnp.asarray(wt), jde.DictMsg(jbank[wt], jbank[wt], *dm_j[2:]), None, True)["params"],
        jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s, r=np.random.RandomState(8): (r.randn(*s.shape) * 0.3).astype(np.float32),
                          params)

    def loss(p):
        x, _, pron_attn, _ = jm.apply({"params": p}, jnp.asarray(wt), dm_j, None, True)
        return jnp.sum(x ** 2) + jnp.sum(pron_attn ** 2), (x, pron_attn)

    (_, (x_j, pron_j)), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    grads = jax_params_to_state(tde.DictEncoder(V, 16, pinyin_vocab=50, dict_embed_dim=E),
                                jax.device_get(grads_j))
    tm = load_jax_params(tde.DictEncoder(V, 16, pinyin_vocab=50, dict_embed_dim=E, dropout=0.0),
                         params).train()
    maps = [torch.tensor(a) for a in (km, pin, pm)]
    tbank = bank_tensor(bank, "cpu")
    x, _, pron_attn, _ = tm(torch.tensor(wt), tde.DictMsg(tbank, tbank, *maps))
    ((x ** 2).sum() + (pron_attn ** 2).sum()).backward()
    assert x.dtype == torch.float32  # ctx_e comes back in the query's dtype
    scale = float(np.abs(x_j).max())
    with torch.no_grad():  # the f32 path on the same values rounds elsewhere: told apart
        bank32 = tbank.float()
        x32 = tm(torch.tensor(wt), tde.DictMsg(bank32, bank32, *maps))[0]
    assert np.abs(x32.numpy() - np.asarray(x_j)).max() > 5 * 3e-5 * scale
    _close(x.detach().numpy(), x_j, "x", scale)
    _close(pron_attn.detach().numpy(), pron_j, "pron_attn", float(np.abs(pron_j).max()))
    named = dict(tm.named_parameters())
    assert set(named) == set(grads)
    top = max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    for name, g in grads.items():
        _close(named[name].grad.numpy(), g, name, top)


@pytest.mark.parametrize("ids", ["uniform", "all_same", "zipf", "runs", "one"])
def test_bank_slot_chunks_partition_the_slots(ids):
    """slot_order, which the kernels cut into chunks: every slot once,
    equal ids side by side, ties in slot order (a stable sort)."""
    rng = np.random.RandomState(3)
    N, Vw = 300, 50
    wt = {"uniform": rng.randint(0, Vw, N), "all_same": np.full(N, 7),
          "zipf": np.minimum(rng.zipf(1.1, N), Vw) - 1,
          "runs": np.repeat(np.arange(6), [1, 8, 9, 17, 30, 235]), "one": np.array([4])}[ids]
    wt = torch.tensor(wt.astype(np.int32))
    sorted_ids, order = slot_order(wt)
    assert sorted_ids.dtype == torch.int32 and order.dtype == torch.int64
    assert sorted(order.tolist()) == list(range(wt.numel()))  # every slot exactly once
    assert torch.equal(sorted_ids, wt[order])
    assert (sorted_ids[1:] >= sorted_ids[:-1]).all()  # equal ids side by side
    same = sorted_ids[1:] == sorted_ids[:-1]
    assert (order[1:][same] > order[:-1][same]).all()  # stable: ties keep slot order


def test_corpus_like_word_ids_have_the_corpus_layout():
    """chip_smoke's main bank-kernel case lays word ids out as the training
    collater lays out the repo's corpus (scripts/corpus_word_id_stats.py):
    per 64-slot sentence a start id, 20-58 words in all, an end id, then
    pad ids."""
    import chip_smoke

    wt = chip_smoke.word_ids(torch.Generator().manual_seed(0), 3840, "corpus").view(60, 64)
    assert wt.dtype == torch.int32
    n = (wt != 0).sum(1)
    assert bool(((n >= 20) & (n <= 58)).all())
    assert bool((wt[:, 0] == 3).all())
    rows = torch.arange(60)
    assert bool((wt[rows, n - 1] == 1).all())  # the end id, then only padding
    pos = torch.arange(64)
    assert bool((wt[pos >= n[:, None]] == 0).all())
    words = wt[(pos > 0) & (pos < n[:, None] - 1)]
    assert bool(((words >= 4) & (words < chip_smoke.BANK_V)).all())
    assert 0.3 < float((wt == 0).float().mean()) < 0.45
