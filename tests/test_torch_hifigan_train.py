"""Port parity of HiFi-GAN vocoder training (``dicttts_tpu_torch/models/hifigan.py``
discriminators, ``train/stft_loss.py``, ``data/datasets.VocoderDataset``,
``train/tasks/hifigan.py``, ``run.py``) against the JAX package, on the CPU.

The discriminators are at the recipe's (fixed) widths, the generator at
width 32, crops of 1024 samples. Weights: the JAX task's seeded init,
loaded into the port through ``convert.py``. Tolerances, with what they
rest on:
- the MPD and MSD from converted weights: scores and feature maps within
  rtol 1e-4 / atol 1e-5 of the largest value (f32 convolutions of up to
  1024 channels summed in another order; measured below 2e-6);
- the losses: rtol 1e-5, atol 1e-6 (the training slice's);
- one step and the next: every loss at rtol 1e-5 / atol 1e-6 and every
  parameter of G and D after the step at atol 1e-6 plus what a gradient
  difference at the gradient tolerance (rtol 1e-3, atol 1e-6 of the
  largest) can move one Adam step, lr * tol_g / (sqrt(v_hat) + eps), as
  tests/test_torch_accumulate.py argues (``_adam_atol``), summed over the
  parameter's updates so far (measured at crops of 2048: 2 of the
  generator's 71777 elements beyond 1e-6, up to 2.7e-6, and 1 of the
  discriminators' 70.7M, 1.5e-6; at 1024 one generator element reaches
  5.6e-6 after its second update, where one update's term alone is
  1.5-3.7e-6; losses within 1e-5 relative);
- amp: the port's losses under amp within the JAX task's own amp-vs-f32
  gap on the same inputs (the two bf16 policies round different tensors);
- ``VocoderDataset``: batches equal, array for array.
"""

import functools
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_binarizer as TB  # noqa: E402
from test_torch_accumulate import _adam_atol  # noqa: E402
from test_torch_train_task import _as_built  # noqa: E402

from dicttts_tpu.data.datasets import VocoderDataset as JVocoderDataset  # noqa: E402
from dicttts_tpu.models import hifigan as jh  # noqa: E402
from dicttts_tpu.train import stft_loss as jstft  # noqa: E402
from dicttts_tpu.train.losses import feature_matching_loss as j_fm  # noqa: E402
from dicttts_tpu.train.tasks import hifigan as jtask_mod  # noqa: E402
from dicttts_tpu.train.tasks.hifigan import HifiGanTask as JTask  # noqa: E402
from dicttts_tpu_torch import run  # noqa: E402
from dicttts_tpu_torch.config import CONFIG_ROOT  # noqa: E402
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params  # noqa: E402
from dicttts_tpu_torch.data.datasets import VocoderDataset  # noqa: E402
from dicttts_tpu_torch.models import hifigan as th  # noqa: E402
from dicttts_tpu_torch.text import binarize as tbinarize  # noqa: E402
from dicttts_tpu_torch.train import stft_loss as tstft  # noqa: E402
from dicttts_tpu_torch.train.losses import feature_matching_loss as t_fm  # noqa: E402
from dicttts_tpu_torch.train.tasks.hifigan import HifiGanTask  # noqa: E402
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

RECIPE = os.path.join(CONFIG_ROOT, "datasets", "biaobei", "hifigan.yaml")
SEG = 1024  # 4 mel frames: the discriminators (70.7M parameters) set the cost
CFG = dict(upsample_initial_channel=32, max_samples=SEG, max_sentences=2, disc_start_steps=1)


def _wavs(seed, B=2, T=SEG):
    return (0.3 * np.random.RandomState(seed).randn(B, T)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_task():
    """The JAX task, its seeded state and its jitted step. Its generator
    runs with ``fold_lanes=False``: the lane folding is the same math (the
    JAX package's own switch), and at width 32 it folds every stage by 8 to
    64, which takes XLA minutes to compile."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtask_mod, "HifiGanGenerator", functools.partial(jh.HifiGanGenerator, fold_lanes=False))
        jt = JTask(dict(CFG), None)
    yield jt, jt.build_state(jax.random.PRNGKey(0)), jax.jit(jt.train_step)


@pytest.fixture(scope="module")
def disc(jax_task):
    """The JAX MPD and MSD with the JAX task's seeded init, and the port's
    discriminator holding the same weights."""
    params = jax.device_get(jax_task[1]["params_d"])
    port = load_jax_params(th.HifiGanDiscriminator(), params)
    return jh.MultiPeriodDiscriminator(), jh.MultiScaleDiscriminator(), params, port


@pytest.mark.parametrize("T", [2048, 2310, 2001])
def test_discriminators_match_jax(disc, T):
    """T = 2048: divisible by the MSD's strides, not by the periods 3, 5,
    7, 11; 2310: by every period, not by the strides; 2001: by neither."""
    mpd, msd, params, port = disc
    wav = _wavs(T, T=T)
    s_p, f_p = mpd.apply({"params": params["mpd"]}, jnp.asarray(wav))
    s_s, f_s = msd.apply({"params": params["msd"]}, jnp.asarray(wav))
    with torch.no_grad():
        scores, fmaps = port(torch.tensor(wav))
    assert len(scores) == len(fmaps) == 8
    for i, (got, want) in enumerate(zip(scores, s_p + s_s)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"score {i}")
    for i, (got, want) in enumerate(zip(fmaps, f_p + f_s)):
        assert len(got) == len(want) == (6 if i < 5 else 8)
        for j, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            g = (g.permute(0, 2, 3, 1) if g.ndim == 4 else g.transpose(1, 2)).numpy()  # channels last
            assert g.shape == w.shape, (i, j)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=f"fmap {i}.{j}")


@pytest.mark.parametrize("T", [8192, 2001])
def test_same_padding_is_flax(T):
    for k, s in ((41, 4), (41, 2), (15, 1), (5, 1)):
        lo, hi = th.same_pad(T, k, s)
        (want,) = jax.lax.padtype_to_pads((T,), (k,), (s,), "SAME")
        assert (lo, hi) == tuple(want)
    assert th.same_pad(8192, 41, 4) == (18, 19)


def test_losses_match_jax():
    rng = np.random.RandomState(6)
    fake = [rng.randn(2, n).astype(np.float32) for n in (7, 5, 11)]
    real = [rng.randn(2, n).astype(np.float32) for n in (7, 5, 11)]
    t = lambda xs: [torch.tensor(x) for x in xs]  # noqa: E731
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    for got, want in ((th.generator_adv_loss(t(fake)), jh.generator_adv_loss(j(fake))),
                      (th.discriminator_adv_loss(t(real), t(fake)), jh.discriminator_adv_loss(j(real), j(fake))),
                      (t_fm([t(real[:2]), t(real[2:])], [t(fake[:2]), t(fake[2:])]),
                       j_fm([j(real[:2]), j(real[2:])], [j(fake[:2]), j(fake[2:])]))):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    a, b = _wavs(1, T=4000), _wavs(2, T=4000)
    for got, want in zip(tstft.multi_resolution_stft_loss(torch.tensor(a), torch.tensor(b)),
                         jstft.multi_resolution_stft_loss(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)


# -- data ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crops_dir(tmp_path_factory):
    """9 items of wav and mel, some shorter than the crop window."""
    root = tmp_path_factory.mktemp("vocoder")
    rng = np.random.RandomState(3)
    with IndexedDatasetBuilder(str(root / "train")) as b:
        for i in range(9):
            n = int(rng.choice([5, 8, 20, 41]))
            b.add_item({"item_name": f"v{i}", "mel": rng.randn(n, 80).astype(np.float32),
                        "wav": rng.randn(n * 256).astype(np.float32)})
    return str(root)


@pytest.mark.parametrize("max_samples", [2048, 4096])
def test_vocoder_batches_equal_jax(crops_dir, max_samples):
    cfg = {"max_samples": max_samples, "hop_size": 256}
    got, want = VocoderDataset(crops_dir, "train", cfg, batch_size=4), JVocoderDataset(crops_dir, "train", cfg, 4)
    for epoch in range(3):  # training batches draw from one advancing stream
        for which in ("train_batches", "val_batches", "test_batches"):
            g, w = list(getattr(got, which)()), list(getattr(want, which)())
            assert len(g) == len(w) == 2, which
            for bg, bw in zip(g, w):
                assert set(bg) == set(bw) == {"wavs", "mels"}
                for k in bw:
                    assert bg[k].dtype == bw[k].dtype and np.array_equal(bg[k], bw[k]), (epoch, which, k)
                assert bg["wavs"].shape == (4, max_samples) and bg["mels"].shape == (4, max_samples // 256, 80)


def test_vocoder_batches_refuse_items_without_wav(tmp_path):
    with IndexedDatasetBuilder(str(tmp_path / "train")) as b:
        b.add_item({"item_name": "x", "mel": np.zeros((40, 80), np.float32), "wav": None})
    with pytest.raises(ValueError, match="with_wav"):
        next(VocoderDataset(str(tmp_path), "train", {}, batch_size=1).train_batches())


# -- the task ------------------------------------------------------------------------------

def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"wavs": (0.3 * rng.randn(2, SEG)).astype(np.float32),
            "mels": rng.uniform(-5, 0, (2, SEG // 256, 80)).astype(np.float32)}


def _port_task(state, **cfg):
    task = HifiGanTask({**CFG, **cfg}, device="cpu")
    task.build_state(0)
    load_jax_params(task.model, jax.device_get(state["params_g"]))
    load_jax_params(task.disc, jax.device_get(state["params_d"]))
    return task


def test_two_steps_match_the_jax_task(jax_task):
    """Step 0 before disc_start_steps (D frozen, the adversarial term times
    0), step 1 after it: every loss, and G and D after each step."""
    jt, state, jstep = jax_task
    task = _port_task(state)
    adam = {}  # per parameter: the Adam terms of its updates so far, summed
    for step in range(2):
        batch = _batch(step)
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(step))
        tm = task.train_step(task.to_device(batch))
        assert set(tm) - {"grad_norm_g", "grad_norm_d"} == set(jm)
        assert ("grad_norm_d" in tm) == (step >= 1)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=f"{k} @ {step}")
        assert (float(jm["a"]) == 0.0) == (step == 0)
        assert (task.updates_g, task.updates_d) == (step + 1, step)
        for name, module, opt in (("g", task.model, task.opt_g), ("d", task.disc, task.opt_d)):
            want = jax_params_to_state(module, jax.device_get(state[f"params_{name}"]))
            grads = [float(v.grad.abs().max()) for v in module.parameters() if v.grad is not None]
            top = max(grads, default=0.0)
            for n, p in module.named_parameters():
                err = np.abs(p.detach().numpy() - np.asarray(want[n]))
                if p.grad is not None:  # updated this step: its deviation adds to the earlier ones'
                    adam[name, n] = adam.get((name, n), 0.0) + _adam_atol(opt, p, top) - 1e-6
                atol = 1e-6 + adam.get((name, n), 0.0)
                assert (err <= atol).all(), (name, n, step, err.max())


def test_the_discriminator_is_frozen_before_its_start(jax_task):
    _, state, _ = jax_task
    task = _port_task(state, disc_start_steps=1)
    d0 = {k: v.clone() for k, v in task.disc.state_dict().items()}
    for step in range(2):
        metrics = task.train_step(task.to_device(_batch(step)))
        moved = any(not torch.equal(d0[k], v) for k, v in task.disc.state_dict().items())
        assert moved == (step == 1) and ("grad_norm_d" in metrics) == (step == 1)
        assert _as_built(task.opt_d) == (step < 1)
        assert task.updates_d == step and task.updates_g == step + 1
        assert (metrics["a"].item() == 0.0) == (step < 1) and metrics["disc_loss"].item() > 0
        assert all(p.grad is None for p in task.disc.parameters()) == (step < 1)


def test_amp_is_within_the_jax_tasks_amp_gap(jax_task):
    """The losses of one step under amp: |port_amp - jax_amp| <= the
    largest |jax_amp - jax_f32| over the losses, on the same inputs."""
    _, state, _ = jax_task
    batch = _batch(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_losses(amp):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtask_mod, "HifiGanGenerator", functools.partial(jh.HifiGanGenerator, fold_lanes=False))
            jt = JTask(dict(CFG, amp=amp, disc_start_steps=0), None)

        def f(pg, pd, b):
            from dicttts_tpu.ops.amp import amp_scope

            with amp_scope(jt.matmul_precision, None):
                _, (losses, wav) = jt._gen_losses(pg, pd, b, 0, True)
                losses["disc"] = jt._disc_losses(pd, wav, b["wavs"])
            return losses

        return {k: float(v) for k, v in jax.jit(f)(state["params_g"], state["params_d"], jb).items()}

    j32, j16 = jax_losses(False), jax_losses(True)
    port = {}
    for amp in (False, True):
        task = _port_task(state, amp=amp, disc_start_steps=0)
        b = task.to_device(batch)
        with torch.no_grad():
            _, losses, wav = task._gen_losses(b, True)
            losses["disc"] = task._disc_loss(wav, b["wavs"])
        assert all(v.dtype == torch.float32 for v in losses.values())
        port[amp] = {k: v.item() for k, v in losses.items()}
    for k in j32:
        np.testing.assert_allclose(port[False][k], j32[k], rtol=1e-5, atol=1e-6, err_msg=k)
    gap = max(abs(j16[k] - j32[k]) for k in j32)
    err = max(abs(port[True][k] - j16[k]) for k in j32)
    assert 0 < gap < 0.1 and err <= gap, (err, gap, {k: (j32[k], j16[k], port[True][k]) for k in j32})


# -- the entry point -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_binary(tmp_path_factory):
    """The toy corpus binarized with wavs by the port's command line."""
    root = tmp_path_factory.mktemp("hifigan_corpus")
    raw, dict_path = TB._toy_raw(root)
    cfg = TB._toy_cfg(root, "bin", raw, dict_path, with_f0cwt=False, test_num=0, valid_num=0)
    config = root / "cfg.yaml"
    config.write_text(json.dumps(cfg))
    tbinarize.main(["--config", str(config), "--device", "cpu"])
    return cfg["binary_data_dir"]


def test_run_trains_resumes_and_infers(toy_binary, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    small = (f"binary_data_dir={toy_binary},upsample_initial_channel=16,resblock_kernel_sizes=[3],"
             "max_samples=1024,max_sentences=2,disc_start_steps=1,val_check_interval=2,"
             "num_sanity_val_steps=1")

    def main(*args):
        return run.main(["--config", RECIPE, "--exp_name", "voc", "--device", "cpu", *args])

    trainer, task = main("--hparams", small + ",max_updates=2")
    assert isinstance(task, HifiGanTask) and trainer.global_step == 2 and task.updates_d == 1
    assert [h["sentences"] for h in trainer.history] == [2, 2]
    assert [h["frames"] for h in trainer.history] == [4, 4]
    assert set(trainer.val_metrics) == {"mel", "total_loss"}
    assert all(np.isfinite(float(v)) for v in trainer.metrics.values())
    assert os.path.exists(os.path.join("checkpoints", "voc", "model_ckpt_steps_2.ckpt"))
    trainer, task = main("--hparams", small + ",max_updates=3")
    assert trainer.global_step == 3 and task.step == 3 and task.updates_d == 2
    assert len(trainer.history) == 1
    trainer, task = main("--infer", "--hparams", small)
    assert task.step == 3
    assert trainer.test_seconds > 0
    outputs = trainer.test(task)
    assert len(outputs) == 2 and all(o["wav_out"].shape == (2, 4 * 256) for o in outputs)
    assert all(np.isfinite(o["wav_out"]).all() for o in outputs)


def test_run_names_a_corpus_without_binaries(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="dicttts_tpu_torch.text.binarize"):
        run.main(["--config", RECIPE, "--exp_name", "x", "--device", "cpu", "--hparams",
                  f"binary_data_dir={tmp_path}"])


def test_a_torch_adamw_checkpoint_loads():
    """A checkpoint written while the task stepped ``torch.optim.AdamW``
    (before it moved to MaskedAdamW) loads: each optimizer's moments, count
    and lr come through, the update counts agree, and the generator's next
    update equals AdamW's next step."""
    task = HifiGanTask(dict(CFG), device="cpu")
    task.build_state(0)
    gen = torch.Generator().manual_seed(6)
    opts, grads = {}, {}
    for name, module, n in (("g", task.model, 2), ("d", task.disc, 1)):
        params = list(module.parameters())
        opts[name] = torch.optim.AdamW(params, lr=2e-4, betas=(0.8, 0.99), eps=1e-8, weight_decay=1e-4)
        grads[name] = [[torch.randn(p.shape, generator=gen) * 0.1 for p in params] for _ in range(n + 1)]
        for gs in grads[name][:n]:
            for p, g in zip(params, gs):
                p.grad = g.clone()
            opts[name].step()
    buf = io.BytesIO()
    torch.save({"params_g": task.model.state_dict(), "params_d": task.disc.state_dict(),
                "opt_g": opts["g"].state_dict(), "opt_d": opts["d"].state_dict(), "step": 2,
                "updates_g": 2, "updates_d": 1}, buf)
    buf.seek(0)
    loaded = HifiGanTask(dict(CFG), device="cpu")
    loaded.build_state(1)
    loaded.load_state_dict(torch.load(buf, weights_only=True))
    assert (loaded.step, loaded.updates_g, loaded.updates_d) == (2, 2, 1)
    for name, module, mine in (("g", task.model, loaded.model), ("d", task.disc, loaded.disc)):
        opt = getattr(loaded, f"opt_{name}")
        assert float(opt.param_groups[0]["lr"]) == 2e-4
        for p, q in zip(module.parameters(), mine.parameters()):
            assert all(torch.equal(opts[name].state[p][k], opt.state[q][k]) for k in ("exp_avg", "exp_avg_sq"))
    for p, q, g in zip(task.model.parameters(), loaded.model.parameters(), grads["g"][2]):
        p.grad, q.grad = g.clone(), g.clone()
    opts["g"].step()
    loaded.opt_g.update(2e-4)
    for p, q in zip(task.model.parameters(), loaded.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=0, atol=1e-6)
