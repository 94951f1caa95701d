"""The FastSpeech2 recipe through the port's entry point on the CPU
(``dicttts_tpu_torch.run.main`` with configs/datasets/biaobei/fs2.yaml) at
small widths, on a toy corpus (the repo's valid split, .prod_corpus/binary,
copied as train, valid and test): training with validations and
checkpoints, a resume, and ``--infer``.

Checked against the JAX package: the phone-level batches (txt_tokens,
mel2ph, mels, f0 in Hz, uv) that the port's provider hands the task equal,
array for array, the JAX provider's under the same config. Checked on the
port: the step and the optimizer's count across a resume, finite losses,
and --infer outputs of the predicted length, zero past it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from dicttts_tpu import run as jrun
from dicttts_tpu.config import load_config as jload_config
from dicttts_tpu_torch import run
from dicttts_tpu_torch.config import CONFIG_ROOT, load_config
from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "..", ".prod_corpus", "binary")
CONFIG = os.path.join(CONFIG_ROOT, "datasets", "biaobei", "fs2.yaml")
JAX_CONFIG = os.path.join(os.path.dirname(__file__), "..", "dicttts_tpu", "configs", "datasets",
                          "biaobei", "fs2.yaml")
SMALL = ("hidden_size=16,enc_layers=1,dec_layers=1,enc_ffn_kernel_size=3,dec_ffn_kernel_size=3,"
         "max_frames=256,mel_buckets=[128 256],max_sentences=5,tb_log_interval=1")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("fs2_corpus")
    for f in ("word_set.json", "phone_set.json", "spk_map.json"):
        shutil.copy(os.path.join(CORPUS, f), root)
    for split in ("train", "valid", "test"):
        for ext in (".data", ".idx", "_lengths.npy"):
            shutil.copy(os.path.join(CORPUS, "valid" + ext), root / (split + ext))
    return str(root)


def test_phone_batches_match_the_jax_provider(corpus):
    over = {"binary_data_dir": corpus, "max_sentences": 5, "max_frames": 256, "mel_buckets": [128, 256]}
    cfg = run.autoconfigure_vocabs({**load_config(CONFIG, save=False), **over})
    jcfg = jrun.autoconfigure_vocabs({**jload_config(JAX_CONFIG, save=False), **over})
    assert cfg["n_vocab"] == jcfg["n_vocab"] and cfg["use_pitch_embed"] and cfg["pitch_norm"] == "standard"
    got, want = run.build_data_provider(cfg), jrun.build_data_provider(jcfg, jcfg["task_cls"], 1)
    for split in ("train_batches", "val_batches", "test_batches"):
        pairs = list(zip(getattr(got, split)(), getattr(want, split)(), strict=True))
        assert pairs
        for g, w in pairs:
            assert set(g) == set(w) and {"txt_tokens", "mel2ph", "mels", "f0", "uv"} <= set(g)
            for k in w:
                if k != "_meta":
                    assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{split} {k}")
    voiced = (g["uv"] == 0) & (g["mel2ph"] > 0)
    assert g["f0"][voiced].min() > 50  # f0 in Hz: the dataset normalizes without a mean and std


def _main(tmp_path, monkeypatch, *args):
    monkeypatch.chdir(tmp_path)  # work_dir is checkpoints/<exp_name> under the current directory
    return run.main(["--config", CONFIG, "--exp_name", "fs2", "--device", "cpu", *args])


def test_fs2_trains_resumes_and_infers(corpus, tmp_path, monkeypatch):
    hp = f"binary_data_dir={corpus},max_updates=2,val_check_interval=1,num_sanity_val_steps=1,{SMALL}"
    trainer, task = _main(tmp_path, monkeypatch, "--hparams", hp)
    assert isinstance(task, FastSpeech2Task) and type(task.model.encoder).__name__ == "RelTransformerEncoder"
    assert trainer.global_step == task.step == 2
    assert set(trainer.metrics) == {"l1", "ssim", "pdur", "uv", "f0", "total_loss", "grad_norm"}
    assert all(np.isfinite(float(v)) for v in trainer.metrics.values())
    assert trainer.val_metrics and all(np.isfinite(v) for v in trainer.val_metrics.values())
    assert trainer.val_metrics["f0"] > 1e3  # learned in Hz (ROADMAP Queue 3)
    trainer, task = _main(tmp_path, monkeypatch, "--hparams", "max_updates=3")
    assert trainer.global_step == task.step == 3 and [h["step"] for h in trainer.history] == [3]
    assert task.opt.state_dict()["state"][0]["step"] == 3 and task.cfg["hidden_size"] == 16
    trainer, task = _main(tmp_path, monkeypatch, "--infer")
    outputs = trainer.test(task)
    assert len(outputs) == 18  # the test split, one utterance a batch
    for out in outputs:
        assert set(out) == {"mel_out", "mel2ph"}
        n = int((out["mel2ph"][0] > 0).sum())
        assert 0 < n <= 256 and np.isfinite(out["mel_out"]).all()
        assert not out["mel_out"][0, n:].any() and out["mel_out"][0, :n].std() > 0
