"""The PortaSpeech recipes through the port's entry point on the CPU
(``dicttts_tpu_torch.run.main``): configs/datasets/biaobei/ps_adv.yaml, and
ps_flow.yaml with the post-net Glow through both training stages, at small
widths on a toy corpus (the repo's valid split, .prod_corpus/binary, copied
as train, valid and test). Each trains with validations and checkpoints,
resumes, and runs ``--infer``.

Checked against the JAX package: the word batches that the port's
provider hands the PortaSpeech task equal, array for array, the batches of
the JAX package's provider under the same config (``dicttts_tpu.run``).
Checked on the port: the steps, the stages and the optimizers' counts
across a resume, and finite --infer outputs of the predicted length.
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
from dicttts_tpu_torch.train.tasks.ps_adv import PortaSpeechAdvTask
from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "..", ".prod_corpus", "binary")
JAX_ROOT = os.path.join(os.path.dirname(__file__), "..", "dicttts_tpu", "configs")
SMALL = ("hidden_size=16,latent_size=4,fvae_enc_dec_hidden=16,fvae_enc_n_layers=1,"
         "fvae_dec_n_layers=1,prior_glow_hidden=8,prior_glow_n_blocks=1,mel_disc_hidden_size=8,"
         "dur_predictor_layers=2,enc_ffn_kernel_size=3,enc_layers=1,word_enc_layers=1,"
         "post_glow_hidden=8,post_glow_n_blocks=4,post_glow_n_block_layers=1,share_wn_layers=2,"
         "max_frames=256,mel_buckets=[128 256],max_sentences=5,tb_log_interval=1")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ps_corpus")
    for f in ("word_set.json", "phone_set.json", "pinyin_encoder.pkl", "spk_map.json"):
        shutil.copy(os.path.join(CORPUS, f), root)
    for split in ("train", "valid", "test"):
        for ext in (".data", ".idx", "_lengths.npy"):
            shutil.copy(os.path.join(CORPUS, "valid" + ext), root / (split + ext))
    return str(root)


def _config(name):
    return os.path.join(CONFIG_ROOT, "datasets", "biaobei", f"{name}.yaml")


def _main(tmp_path, monkeypatch, name, *args):
    monkeypatch.chdir(tmp_path)  # work_dir is checkpoints/<exp_name> under the current directory
    return run.main(["--config", _config(name), "--exp_name", name, "--device", "cpu", *args])


@pytest.mark.parametrize("name", ["ps_adv", "ps_flow"])
def test_word_batches_match_the_jax_provider(corpus, name):
    over = {"binary_data_dir": corpus, "max_sentences": 5, "max_frames": 256,
            "mel_buckets": [128, 256]}
    cfg = run.autoconfigure_vocabs({**load_config(_config(name), save=False), **over})
    jcfg = jrun.autoconfigure_vocabs(
        {**jload_config(os.path.join(JAX_ROOT, "datasets", "biaobei", f"{name}.yaml"), save=False),
         **over})
    assert cfg["n_vocab"] == jcfg["n_vocab"] and cfg["dur_level"] == jcfg["dur_level"] == "word"
    got, want = run.build_data_provider(cfg), jrun.build_data_provider(jcfg, jcfg["task_cls"], 1)
    for split in ("train_batches", "val_batches", "test_batches"):
        pairs = list(zip(getattr(got, split)(), getattr(want, split)(), strict=True))
        assert pairs
        for g, w in pairs:
            assert set(g) == set(w) and {"txt_tokens", "ph2word", "word_tokens", "mel2word"} <= set(g)
            for k in w:
                if k != "_meta":
                    assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{split} {k}")


def _infer_outputs(outputs, max_frames=256):
    assert len(outputs) == 18  # the test split, one utterance a batch
    for out in outputs:
        assert set(out) == {"mel_out", "mel2word", "attn"}
        n = int((out["mel2word"][0] > 0).sum())
        assert 0 < n <= max_frames and np.isfinite(out["mel_out"]).all()
        assert not out["mel_out"][0, n:].any() and out["mel_out"][0, :n].std() > 0


def test_ps_adv_trains_resumes_and_infers(corpus, tmp_path, monkeypatch):
    hp = f"binary_data_dir={corpus},max_updates=2,val_check_interval=1,num_sanity_val_steps=1,{SMALL}"
    trainer, task = _main(tmp_path, monkeypatch, "ps_adv", "--hparams", hp)
    assert isinstance(task, PortaSpeechAdvTask) and not isinstance(task, PortaSpeechFlowTask)
    assert trainer.global_step == task.step == task.updates_g == task.updates_d == 2
    assert trainer.val_metrics and all(np.isfinite(v) for v in trainer.val_metrics.values())
    assert {"kl", "ssim", "l1", "wdur", "a", "r", "f"} <= set(trainer.metrics)
    trainer, task = _main(tmp_path, monkeypatch, "ps_adv", "--hparams", "max_updates=3")
    assert trainer.global_step == task.step == task.updates_d == 3
    assert [h["step"] for h in trainer.history] == [3] and task.cfg["hidden_size"] == 16
    trainer, task = _main(tmp_path, monkeypatch, "ps_adv", "--infer")
    assert trainer.global_step == 3
    _infer_outputs(trainer.test(task))


def test_ps_flow_post_glow_trains_both_stages_resumes_and_infers(corpus, tmp_path, monkeypatch):
    hp = (f"binary_data_dir={corpus},max_updates=3,val_check_interval=3,num_sanity_val_steps=1,"
          f"use_post_glow=True,post_glow_training_start=2,{SMALL}")
    trainer, task = _main(tmp_path, monkeypatch, "ps_flow", "--hparams", hp)
    assert isinstance(task, PortaSpeechFlowTask) and task.staged
    assert (task.step, task.updates_g, task.updates_pf, task.updates_d) == (3, 2, 1, 0)
    assert float(trainer.metrics["post_stage"]) == 1.0 and "postflow" in trainer.val_metrics
    pf = {n: p.detach().clone() for n, p in task.model.named_parameters() if "post_flow" in n}
    trainer, task = _main(tmp_path, monkeypatch, "ps_flow", "--hparams", "max_updates=5")
    assert (task.step, task.updates_g, task.updates_pf, task.updates_d) == (5, 2, 3, 0)
    assert task.opt_pf.state_dict()["state"][0]["step"] == 3  # the Glow's optimizer was restored
    assert any(not p.equal(pf[n]) for n, p in task.model.named_parameters() if n in pf)
    trainer, task = _main(tmp_path, monkeypatch, "ps_flow", "--infer")
    _infer_outputs(trainer.test(task))
