"""The trainer's TensorBoard logs and the validation artifacts
(``dicttts_tpu_torch/utils/plot.py``, ``Trainer.writer``,
``DictTTSTask.validation_artifacts``) against the JAX package's.

- the figures draw the JAX figures' data;
- for one schedule (2 steps, validation every step, artifacts every 2),
  the port's event file holds the JAX trainer's tags at the JAX trainer's
  steps, plus the gradient norms the port's step reports
  (``tr/grad_norm_g``, ``tr/grad_norm_d``);
- ``validation_artifacts`` gives the JAX task's figure names and its
  audio names (its vocoder takes XLA minutes to compile here, so the JAX
  audio is not run);
- an artifact that raises logs a warning and training goes on.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from dicttts_tpu.data.providers import SyntheticDictTTSProvider as JSynth
from dicttts_tpu.parallel.mesh import make_mesh
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask
from dicttts_tpu.train.trainer import Trainer as JTrainer
from dicttts_tpu.utils import plot as jplot
from dicttts_tpu_torch.data.providers import SyntheticDictTTSProvider
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.train.trainer import Trainer
from dicttts_tpu_torch.utils import plot

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

CFG = {"word_size": 50, "hidden_size": 16, "num_heads": 2, "enc_ffn_kernel_size": 3,
       "value_embedding_size": 20, "dict_embed_dim": 16, "latent_size": 4, "fvae_enc_dec_hidden": 16,
       "fvae_enc_n_layers": 1, "fvae_dec_n_layers": 1, "prior_glow_hidden": 8, "prior_glow_n_blocks": 1,
       "mel_disc_hidden_size": 8, "disc_win_num": 1, "max_frames": 64, "dur_predictor_layers": 2,
       "use_device_dict_bank": False, "upsample_initial_channel": 16}
SCHEDULE = dict(max_updates=2, val_check_interval=1, num_sanity_val_steps=0, valid_infer_interval=2)


def test_figures_draw_the_jax_figures_data():
    rng = np.random.RandomState(0)
    mel, gt = rng.randn(30, 8), rng.randn(24, 8)
    for fn, args in (("spec_figure", (mel, gt)), ("attn_figure", (rng.rand(6, 5), "t"))):
        got, want = getattr(plot, fn)(*args), getattr(jplot, fn)(*args)
        a, b = got.axes[0].collections or got.axes[0].images, want.axes[0].collections or want.axes[0].images
        np.testing.assert_array_equal(np.asarray(a[0].get_array()), np.asarray(b[0].get_array()))
        assert got.axes[0].get_title() == want.axes[0].get_title()
    for fn, args in (("dur_figure", (rng.rand(5), rng.rand(5), list("abcde"))),
                     ("f0_figure", (rng.rand(9), rng.rand(9))),
                     ("dict_attn_figure", (rng.rand(4), ["x", "y", "z", "w"], "c"))):
        got, want = getattr(plot, fn)(*args), getattr(jplot, fn)(*args)
        assert len(got.axes[0].patches) == len(want.axes[0].patches)
        assert len(got.axes[0].lines) == len(want.axes[0].lines)


def _tags(logdir):
    acc = EventAccumulator(str(logdir), size_guidance={"scalars": 0, "images": 0, "audio": 0})
    acc.Reload()
    out = set()
    for kind in ("scalars", "images", "audio"):
        for tag in acc.Tags()[kind]:
            items = getattr(acc, {"scalars": "Scalars", "images": "Images", "audio": "Audio"}[kind])(tag)
            out |= {(kind, tag, e.step) for e in items}
    return out


class _JaxContract:
    """The JAX Dict-TTS task's side of the JAX trainer's contract with its
    metric names (traced, not compiled: the JAX step takes minutes to
    compile here) and its artifacts' names, behind steps that compile at
    once: the JAX trainer's logging schedule at the cost of a few traces."""

    def __init__(self, jt, data, artifact_names):
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(jt.build_state, key)
        batch = next(iter(data.train_batches()))
        self.train_keys = list(jax.eval_shape(jt.train_step, shapes, batch, key)[1])
        self.val_keys = list(jax.eval_shape(jt.val_step, shapes, batch, key))
        self.data, self.artifact_names = data, artifact_names

    def build_state(self, rng):
        return {"step": jnp.zeros((), jnp.int32)}

    def train_step(self, state, batch, rng):
        return {"step": state["step"] + 1}, {k: jnp.float32(1.0) for k in self.train_keys}

    def val_step(self, state, batch, rng):
        return {k: jnp.float32(1.0) for k in self.val_keys}

    def train_batches(self):
        return self.data.train_batches()

    def val_batches(self):
        return self.data.val_batches()

    def validation_artifacts(self, state, batch, rng):
        return {kind: {n: (jplot.attn_figure(np.eye(2)) if kind == "figures" else (np.zeros(8), 22050))
                       for n in names} for kind, names in self.artifact_names.items()}


# the JAX task's audio names (dicttts_tpu/train/tasks/dict_tts.py validation_artifacts):
# its HiFi-GAN takes XLA minutes to compile here, so its audio is not run
JAX_AUDIO = {"pred", "gt_mel_vocoded"}


@pytest.fixture(scope="module")
def jax_artifacts():
    """The JAX task's ``validation_artifacts`` (figures) of a synthetic
    batch, on seeded random weights."""
    data = JSynth(n_items=2, batch_size=2)
    jt = JTask(dict(CFG), data)
    shapes = jax.eval_shape(lambda r: jt.build_state(r)["params_g"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.2).astype(np.float32), shapes)
    return jt.validation_artifacts({"params_g": params}, next(iter(data.val_batches())),
                                   jax.random.PRNGKey(0))


def test_the_event_file_holds_the_jax_trainers_tags(tmp_path, jax_artifacts):
    data = JSynth(n_items=4, batch_size=2)
    contract = _JaxContract(JTask(dict(CFG, dropout=0.0), data), data,
                            {"figures": set(jax_artifacts["figures"]), "audio": set()})
    jtrainer = JTrainer(str(tmp_path / "jax"), tb_log_interval=1, mesh=make_mesh(1), seed=0, **SCHEDULE)
    jtrainer.fit(contract)
    jtrainer._get_writer().close()  # the JAX trainer never flushes its writer
    task = DictTTSTask(dict(CFG, dropout=0.0), SyntheticDictTTSProvider(n_items=4, batch_size=2),
                       device="cpu")
    Trainer(str(tmp_path / "port"), log_interval=1, seed=0, device="cpu", **SCHEDULE).fit(task)
    want, got = _tags(tmp_path / "jax" / "tb"), _tags(tmp_path / "port" / "tb")
    extra = {("scalars", f"tr/grad_norm_{n}", s) for n in "gd" for s in (1, 2)}
    assert got == want | extra
    assert ("images", "mel_gt_vs_pred", 2) in got and ("scalars", "val/total_loss", 1) in got


def test_validation_artifacts_keys(jax_artifacts):
    data = SyntheticDictTTSProvider(n_items=2, batch_size=2)
    task = DictTTSTask(dict(CFG, log_val_audio=True), data, device="cpu")
    task.build_state(0)
    arts = task.validation_artifacts(task.to_device(next(iter(data.val_batches()))),
                                     torch.Generator().manual_seed(0))
    assert set(arts) == set(jax_artifacts) == {"figures", "audio"}
    assert set(arts["figures"]) == set(jax_artifacts["figures"]) and set(arts["audio"]) == JAX_AUDIO
    (wav, sr), n = arts["audio"]["gt_mel_vocoded"], int(next(iter(data.val_batches()))["mel_lengths"][0])
    assert sr == 22050 and wav.shape == (n * task._vocoder.hop,) and np.isfinite(wav).all()


def test_a_failing_artifact_does_not_stop_training(tmp_path, monkeypatch, caplog):
    data = SyntheticDictTTSProvider(n_items=2, batch_size=2)
    task = DictTTSTask(dict(CFG), data, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("no figure")

    monkeypatch.setattr(task, "validation_artifacts", boom)
    trainer = Trainer(str(tmp_path), max_updates=2, val_check_interval=1, num_sanity_val_steps=0,
                      device="cpu")
    with caplog.at_level(logging.WARNING, logger="dicttts_tpu_torch.trainer"):
        trainer.fit(task)
    assert trainer.global_step == 2
    assert sum("validation artifact logging failed" in r.getMessage() for r in caplog.records) == 2


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    import matplotlib.pyplot as plt

    plt.close("all")
    jax.clear_caches()
