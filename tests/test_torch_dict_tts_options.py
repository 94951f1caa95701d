"""Port parity of the Dict-TTS recipe's other settings against the JAX
package: the S2PA ``sense`` and ``gumbel`` modes, multi-speaker ids, the
prior without its flow, the discriminator without instance norm, its
``sum`` reduction, the JCU discriminator, the unfused bank branch and the
WenetSpeech config tree.

Each setting runs through the task as tests/test_torch_train_task.py
runs the recipe: the JAX task on gathered banks, the port on the device
bank (or on the same gathered banks), the same seeded weights carried
across by ``convert.py``, dropout 0, and the posterior noise, the crop
starts and the Gumbel noise drawn from numpy for both sides. Tolerances
are that file's: losses rtol 1e-5 / atol 1e-6, gradients rtol 1e-3 /
atol 1e-6 of the largest gradient of their parameter set. The remaps and
the S2PA module alone: atol 1e-6 (the same f32 sums in another order).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_train_task as T  # noqa: E402

from dicttts_tpu import config as jconfig  # noqa: E402
from dicttts_tpu.data.datasets import TTSBatchProvider as JProvider  # noqa: E402
from dicttts_tpu.data.datasets import TTSBinaryDataset as JDataset  # noqa: E402
from dicttts_tpu.models import dict_encoder as jde  # noqa: E402
from dicttts_tpu.models import discriminator as jdisc  # noqa: E402
from dicttts_tpu.text.binarizer import ZhBinarizer  # noqa: E402
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask  # noqa: E402
from dicttts_tpu_torch import config as tconfig  # noqa: E402
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params  # noqa: E402
from dicttts_tpu_torch.data.datasets import TTSBatchProvider, TTSBinaryDataset  # noqa: E402
from dicttts_tpu_torch.models import dict_encoder as tde  # noqa: E402
from dicttts_tpu_torch.models.discriminator import JCUDiscriminator  # noqa: E402
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

U = np.array([0.3, 0.8, 0.45], np.float32)
S = 4  # s2pa_max_senses in these tests


def _maps(rng, B, Tw, L, P):
    km = rng.randint(0, 4, (B, Tw, L)).astype(np.int32)
    km[0, 1] = 0  # a word with no sense
    pm = np.tile(np.array([1, 1, 2, 2, 3, 0], np.int32)[:P], (B, Tw, 1))
    return km, pm


@pytest.mark.parametrize("mode", ["sense", "gumbel"])
def test_grouped_remaps_and_their_gradients_match_jax(mode, monkeypatch):
    rng = np.random.RandomState(0)
    B, Tw, L, P = 2, 5, 7, 6
    w = np.asarray(jax.nn.softmax(rng.randn(B, Tw, L) * 2, -1))
    km, pm = _maps(rng, B, Tw, L, P)
    noise = rng.gumbel(size=(B, Tw, S)).astype(np.float32)
    coef = rng.randn(B, Tw, P).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype: jnp.asarray(noise, dtype))

    def jf(w):
        out = jde.sense_remap_grouped(w, jnp.asarray(km), jnp.asarray(pm), S, mode=mode,
                                      rng=jax.random.PRNGKey(0) if mode == "gumbel" else None)
        return jnp.sum(out * coef), out

    (_, want), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    got = tde.sense_remap_grouped(tw, torch.tensor(km), torch.tensor(pm), S, mode,
                                  noise=torch.tensor(noise) if mode == "gumbel" else None)
    (got * torch.tensor(coef)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)
    assert np.all(got.detach().numpy()[0, 1] == 0)  # no sense, no mass
    if mode == "gumbel":  # hard: each word picks one sense, two pinyin slots each
        assert set(np.unique(got.detach().numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("branch", ["eager", "bank"])
@pytest.mark.parametrize("mode", ["token", "sense", "gumbel"])
def test_s2pa_sense_modes_in_training_match_jax(mode, branch, monkeypatch):
    """The S2PA module in training mode in both branches and every sense
    mode: outputs and the gradients of a fixed projection of them (the JAX
    bank branch runs its kernel in interpret mode)."""
    rng = np.random.RandomState(1)
    B, Tw, L, P, E, H, V = 2, 5, 6, 6, 16, 8, 12
    x = rng.randn(B, Tw, H).astype(np.float32)
    bank = (rng.randn(V, L, E) * 0.5).astype(np.float32)
    wt = rng.randint(1, V, (B, Tw)).astype(np.int32)
    km, pm = _maps(rng, B, Tw, L, P)
    if branch == "bank":
        # the JAX bank kernel's backward is wrong on an all-masked slot
        # (ROADMAP Queue 3), so this branch has none
        km[0, 1, 0] = 1
    pinyin = rng.randint(1, 20, (B, Tw, P)).astype(np.int32)
    noise = rng.gumbel(size=(B, Tw, S)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype: jnp.asarray(noise, dtype))
    monkeypatch.setattr(tde, "gumbel_noise", lambda shape, generator, device: torch.tensor(noise))
    keys = bank if branch == "bank" else bank[wt]
    dm = jde.DictMsg(jnp.asarray(keys), jnp.asarray(keys), jnp.asarray(km), jnp.asarray(pinyin),
                     jnp.asarray(pm))
    jm = jde.S2PAAttention(H, pinyin_vocab=20, dropout_rate=0.0, sense_mode=mode,
                           max_senses=S)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), dm, word_tokens=jnp.asarray(wt))
    coef = [rng.randn(*s).astype(np.float32) for s in ((B, Tw, H), (B, Tw, L), (B, Tw, H), (B, Tw, P))]

    def jf(p):
        outs = jm.apply(p, jnp.asarray(x), dm, None, False, word_tokens=jnp.asarray(wt),
                        rngs={"dropout": jax.random.PRNGKey(1)})
        return sum(jnp.sum(o * c) for o, c in zip(outs, coef)), outs

    (_, want), jgrads = jax.value_and_grad(jf, has_aux=True)(params)
    tm = load_jax_params(tde.S2PAAttention(H, E, 20, sense_mode=mode, max_senses=S),
                         jax.device_get(params["params"])).train()
    tkeys = torch.tensor(keys)
    tdm = tde.DictMsg(tkeys, tkeys, *(torch.tensor(a) for a in (km, pinyin, pm)))
    outs = tm(torch.tensor(x), tdm, word_tokens=torch.tensor(wt))
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, coef)).backward()
    for name, g, w in zip(("ctx", "align", "pron", "pron_weights"), outs, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)
    ref = jax_params_to_state(tm, jax.device_get(jgrads["params"]))
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[n], rtol=1e-4, atol=1e-6, err_msg=n)


def _pin_jax(monkeypatch, eps, gumbel=None):
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(eps, dtype) if tuple(shape) == eps.shape else normal(key, shape, dtype)))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(U))
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", T._NoDropoutBlock)
    if gumbel is not None:
        monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype: jnp.asarray(gumbel, dtype))
        monkeypatch.setattr(tde, "gumbel_noise", lambda shape, generator, device: torch.tensor(gumbel))


def _gathered(batch, bank):
    wt = batch["word_tokens"]
    return dict(batch, keys=bank["keys"][wt], values=bank["keys"][wt],
                **{k: bank[k][wt] for k in ("key_map", "pinyin", "pinyin_map")})


def _jax_losses_and_grads(cfg, jbatch):
    """The JAX task's losses and gradients from seeded random weights."""
    jt = JTask(dict(cfg), None)
    state = jax.eval_shape(lambda r: {k: v for k, v in jt.build_state(r).items()
                                      if k.startswith("params")}, jax.random.PRNGKey(0))
    params_g = T._randomize(state["params_g"], 2, 0.2)
    params_d = T._randomize(state["params_d"], 3, 0.05)
    jbatch = {k: jnp.asarray(v) for k, v in jbatch.items()}
    key = jax.random.PRNGKey(5)
    (loss_g, (g_losses, out)), grads_g = jax.jit(
        jax.value_and_grad(lambda pg, pd, bt, k: jt._gen_losses(pg, pd, bt, k, True, 1.0),
                           has_aux=True))(params_g, params_d, jbatch, key)
    (loss_d, d_losses), grads_d = jax.jit(jax.value_and_grad(jt._disc_losses, has_aux=True))(
        params_d, out["mel_out"], jbatch["mels"], jbatch["mel_lengths"], key)
    losses = {**g_losses, **d_losses, "total": loss_g, "disc": loss_d}
    return params_g, params_d, {k: float(v) for k, v in losses.items()}, grads_g, grads_d


def _port_matches(task, params_g, params_d, batch, eps, want, grads_g, grads_d):
    load_jax_params(task.model, params_g)
    load_jax_params(task.disc, params_d)
    tbatch = task.to_device(batch)
    starts = torch.tensor(T._starts(U, batch["mel_lengths"]))
    task.model.train()
    task.disc.train()
    loss_g, losses, out = task._gen_losses(tbatch, None, True, 1.0, torch.tensor(eps), starts)
    loss_g.backward()
    loss_d, d_losses = task._disc_losses(out["mel_out"].detach(), tbatch["mels"], tbatch["mel_lengths"],
                                         None, starts)
    loss_d.backward()
    got = {**losses, **d_losses, "total": loss_g, "disc": loss_d}
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].item(), ref, rtol=1e-5, atol=1e-6, err_msg=name)
    T._compare_grads(task.model, grads_g, 1e-6)
    T._compare_grads(task.disc, grads_d, 1e-6)


SETTINGS = {
    "flow-less prior": {"use_prior_glow": False},
    "disc without norm": {"disc_norm": "none"},
    "disc sum reduction": {"disc_reduction": "sum"},
    "sense mode": {"s2pa_sense_mode": "sense", "s2pa_max_senses": S},
    "gumbel mode": {"s2pa_sense_mode": "gumbel", "s2pa_max_senses": S},
    "unfused bank": {"s2pa_bank_fused": False},
    "unfused bf16 bank": {"s2pa_bank_fused": False},
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_setting_matches_the_jax_task(name, monkeypatch):
    settings = SETTINGS[name]
    bank, batch = T._bank(0), T._batch(1)
    if "bf16" in name:
        bank["keys"] = bank["keys"].astype(ml_dtypes.bfloat16)
    rng = np.random.RandomState(4)
    eps = rng.randn(T.B, T.T // 4, T.CFG["latent_size"]).astype(np.float32)
    gumbel = rng.gumbel(size=(T.B, T.TW, S)).astype(np.float32)
    _pin_jax(monkeypatch, eps, gumbel if "gumbel" in name else None)
    cfg = dict(T.CFG, **settings)
    params_g, params_d, want, grads_g, grads_d = _jax_losses_and_grads(cfg, _gathered(batch, bank))
    task = DictTTSTask({**cfg, "disc_dropout": 0.0}, bank=bank, device="cpu")
    task.build_state(0)
    if "unfused" in name:
        assert not task.bank_fused and task.bank["keys"].dtype == (
            torch.bfloat16 if "bf16" in name else torch.float32)
        monkeypatch.setattr(tde, "s2pa_bank_attend", lambda *a: pytest.fail("K1/K2 launched"))
        dm = task._dict_msg(task.to_device(batch))
        assert dm.keys.shape == (T.B, T.TW, T.L, T.E) and dm.keys.dtype == task.bank["keys"].dtype
    else:
        assert task.bank_fused
    if name == "flow-less prior":
        assert task.model.fvae.prior_flow is None
    _port_matches(task, params_g, params_d, batch, eps, want, grads_g, grads_d)


TOY_DICT = {"你": {"nǐ": ["代词。"]}, "好": {"hǎo": ["优点多的。"], "hào": ["喜爱。"]},
            "天": {"tiān": ["日。"]}, "气": {"qì": ["流体。"]}}


@pytest.fixture(scope="module")
def two_speakers(tmp_path_factory):
    """A two-speaker corpus binarized by the JAX package, as
    tests/test_multispeaker.py builds one."""
    import test_multispeaker as M

    root = tmp_path_factory.mktemp("two_speakers")
    raw = root / "raw"
    raw.mkdir()
    dict_path = str(root / "zh-dict.json")
    with open(dict_path, "w") as f:
        json.dump(TOY_DICT, f, ensure_ascii=False)
    for name in ["a1", "a2", "a3", "b1", "b2", "b3"]:
        t = np.arange(int(22050 * 0.9)) / 22050
        wav = 0.3 * np.sin(2 * np.pi * (180 if name[0] == "a" else 260) * t)
        M.save_wav(str(raw / f"{name}.wav"), wav.astype(np.float32))
    cfg = {"raw_data_dir": str(raw), "processed_data_dir": str(root / "processed"),
           "binary_data_dir": str(root / "binary"), "dict_path": dict_path, "word_size": 50,
           "dict_embed_dim": 16, "test_num": 1, "valid_num": 1, "use_dict": True, "use_spk_id": True,
           "num_spk": 2, "binarize_batch": 4}
    M.TwoSpeakerPreAlign(cfg).process()
    ZhBinarizer(cfg).process()
    return cfg


def test_multi_speaker_ids_match_the_jax_task(two_speakers, monkeypatch):
    """The port reads the speakers' ids as the JAX dataset does, and a step
    with the speaker embedding matches the JAX task's on that batch."""
    data_cfg = dict(two_speakers, max_frames=256, max_tokens=4000, max_sentences=4, use_pitch_embed=False,
                    mel_buckets=[128, 256], txt_buckets=[16], frames_multiple=4)
    port_batch = next(iter(TTSBatchProvider(TTSBinaryDataset(data_cfg["binary_data_dir"], "train", data_cfg),
                                            data_cfg, shuffle=False).train_batches()))
    jax_batch = next(iter(JProvider(JDataset(data_cfg["binary_data_dir"], "train", data_cfg),
                                    data_cfg, shuffle=False).train_batches()))
    assert port_batch.pop("_meta") == jax_batch.pop("_meta")
    assert set(port_batch) == set(jax_batch)
    for k, v in jax_batch.items():
        assert np.array_equal(port_batch[k], v) and port_batch[k].dtype == v.dtype, k
    assert sorted(set(port_batch["spk_ids"].tolist())) == [0, 1]
    batch = {k: v for k, v in port_batch.items() if k not in ("txt_tokens", "txt_lengths", "ph2word", "mel2ph")}
    B, Tm = batch["mel2word"].shape
    eps = np.random.RandomState(4).randn(B, Tm // 4, T.CFG["latent_size"]).astype(np.float32)
    _pin_jax(monkeypatch, eps)
    cfg = dict(T.CFG, word_size=50, dict_embed_dim=16, use_spk_id=True, num_spk=2,
               use_device_dict_bank=False)
    params_g, params_d, want, grads_g, grads_d = _jax_losses_and_grads(cfg, batch)
    assert params_g["spk_embed_proj"]["embedding"].shape == (2, T.CFG["hidden_size"])
    task = DictTTSTask({**cfg, "disc_dropout": 0.0}, device="cpu")
    task.build_state(0)
    assert task.model.spk_embed_proj.weight.shape == (2, T.CFG["hidden_size"]) and task.bank is None
    _port_matches(task, params_g, params_d, batch, eps, want, grads_g, grads_d)


def test_jcu_discriminator_matches_jax():
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 32, 80).astype(np.float32)
    cond = rng.randn(2, 32, 24).astype(np.float32)
    jm = jdisc.JCUDiscriminator(c_base=16)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(cond))
    coef = rng.randn(2, 16, 1).astype(np.float32)

    def jf(p):
        o = jm.apply(p, jnp.asarray(mel), jnp.asarray(cond))
        return jnp.sum(o["y"] * coef) + jnp.sum(o["y_c"] ** 2), o

    (_, want), jgrads = jax.value_and_grad(jf, has_aux=True)(params)
    tm = load_jax_params(JCUDiscriminator(80, 24, 16), jax.device_get(params["params"]))
    out = tm(torch.tensor(mel), torch.tensor(cond))
    ((out["y"] * torch.tensor(coef)).sum() + (out["y_c"] ** 2).sum()).backward()
    for k in ("y", "y_c"):
        assert out[k].shape == (2, 16, 1)
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    ref = jax_params_to_state(tm, jax.device_get(jgrads["params"]))
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[n], rtol=1e-4, atol=1e-5, err_msg=n)


WENET = "datasets/wenetspeech/dict_tts.yaml"


def test_wenetspeech_config_resolves_as_the_jax_tree():
    jax_path = os.path.join(os.path.dirname(__file__), "..", "dicttts_tpu", "configs", WENET)
    port_path = os.path.join(tconfig.CONFIG_ROOT, WENET)
    want = jconfig.load_config(jax_path, save=False)
    got = tconfig.load_config(port_path, save=False)
    assert set(got) == set(want)
    for key in want:
        if key == "task_cls":
            assert got[key] == "dicttts_tpu_torch.train.tasks.dict_tts.DictTTSTask"
        else:
            assert got[key] == want[key] and type(got[key]) is type(want[key]), key
    with open(jax_path) as f, open(port_path) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    assert got["use_spk_id"] is True and got["num_spk"] == 2000
    task = DictTTSTask({**got, **T.CFG, "use_device_dict_bank": False}, device="cpu")
    assert task.build_model().spk_embed_proj.weight.shape == (2000, T.CFG["hidden_size"])
