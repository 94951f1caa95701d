"""The port's entry point end to end on the CPU (dicttts_tpu_torch.run),
with its trainer, checkpoints and PER scoring.

``run.main`` trains the recipe at small widths on a toy corpus: the repo's
valid split (.prod_corpus/binary) copied as train, valid and test, with a
small dict_embed for all 8000 word ids. Two steps with a validation and a
checkpoint each, then a resume to step 3, then ``--infer``. Checked: the
sanity validation counts for nothing, validation means weight each batch
by its sentence count, the best checkpoint follows ``valid_monitor_key``,
the resume continues from the saved step and best value, and ``meta.csv``
has the JAX layout with the pinyin column that the JAX package's
``decode_pinyin_ids`` gives for the same ``pinyin_pred``. ``eval/per.py``,
``load_partial`` and the best checkpoint are held against the JAX
package's behaviour on small files."""

import csv
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from dicttts_tpu.eval import per as jper
from dicttts_tpu.utils.text_encoder import TokenTextEncoder
from dicttts_tpu_torch import run
from dicttts_tpu_torch.config import CONFIG_ROOT
from dicttts_tpu_torch.eval import per as tper
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task
from dicttts_tpu_torch.train.trainer import Trainer
from dicttts_tpu_torch.utils import checkpoint as ckpt
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "..", ".prod_corpus", "binary")
RECIPE = os.path.join(CONFIG_ROOT, "datasets", "biaobei", "dict_tts.yaml")
SMALL = ("hidden_size=16,dict_embed_dim=8,latent_size=4,fvae_enc_dec_hidden=16,fvae_enc_n_layers=1,"
         "fvae_dec_n_layers=1,prior_glow_hidden=8,prior_glow_n_blocks=1,mel_disc_hidden_size=8,"
         "dur_predictor_layers=2,enc_ffn_kernel_size=3,max_frames=256,mel_buckets=[128 256],"
         "max_sentences=5,tb_log_interval=1")
HEADER = ["", "item_name", "text", "pinyin_tokens", "wav_fn_pred", "wav_fn_gt"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_corpus")
    for f in ("word_set.json", "phone_set.json", "pinyin_encoder.pkl", "spk_map.json"):
        shutil.copy(os.path.join(CORPUS, f), root)
    for split in ("train", "valid", "test"):
        for ext in (".data", ".idx", "_lengths.npy"):
            shutil.copy(os.path.join(CORPUS, "valid" + ext), root / (split + ext))
    with open(os.path.join(CORPUS, "pinyin_encoder.pkl"), "rb") as f:
        pinyin = pickle.load(f)
    rng = np.random.RandomState(0)
    with IndexedDatasetBuilder(str(root / "dict_embed")) as b:
        for _ in range(8000):
            n, ns = rng.randint(1, 12), rng.randint(1, 4)
            b.add_item({"key": rng.randn(n, 8).astype(np.float16),
                        "key_map": np.arange(n) * ns // n + 1,
                        "pinyin": [pinyin[j] for j in rng.randint(2, len(pinyin), 2 * ns)],
                        "pinyin_map": np.repeat(np.arange(1, ns + 1), 2)})
    return str(root)


def _main(tmp_path, monkeypatch, *args):
    monkeypatch.chdir(tmp_path)  # work_dir is checkpoints/<exp_name> under the current directory
    return run.main(["--config", RECIPE, "--exp_name", "toy", "--device", "cpu", *args])


def test_run_trains_resumes_keeps_the_best_and_infers(corpus, tmp_path, monkeypatch):
    evals = []
    evaluate = Trainer.evaluate

    def recording(self, task, batches, max_batches=None, sanity=False):
        batches = list(batches)
        means = evaluate(self, task, batches, max_batches, sanity)
        evals.append((self.global_step, sanity, batches, means))
        return means

    monkeypatch.setattr(Trainer, "evaluate", recording)
    hp = (f"binary_data_dir={corpus},max_updates=2,val_check_interval=1,num_sanity_val_steps=1,"
          f"valid_monitor_key=l1,{SMALL}")
    trainer, task = _main(tmp_path, monkeypatch, "--hparams", hp)
    work_dir = os.path.join("checkpoints", "toy")
    assert trainer.global_step == task.step == 2 and len(trainer.history) == 2
    assert [h["sentences"] for h in trainer.history] == [5, 5]
    assert {"bank", "frame_cache"} <= set(task.uploads)
    assert task.frame_cache["mels"].shape == (18, 256, 80)
    # the sanity pass ran first, on one batch, and set no best value
    (s_step, sanity, s_batches, _), *vals = evals
    assert sanity and s_step == 0 and len(vals) == 2 and not any(v[1] for v in vals)
    # the means weight each batch by its sentences (18 = 5 + 5 + 5 + 3)
    step, _, batches, means = vals[-1]
    sizes = [b["word_tokens"].shape[0] for b in batches]
    assert sizes == [5, 5, 5, 3]
    per_batch = [task.val_step(task.to_device({k: v for k, v in b.items() if k != "_meta"}),
                               torch.Generator().manual_seed(trainer.seed + i))
                 for i, b in enumerate(batches)]
    for k, v in means.items():
        want = sum(float(m[k]) * n for m, n in zip(per_batch, sizes)) / 18
        assert v == pytest.approx(want, rel=1e-6), k
    assert means["total_loss"] != pytest.approx(np.mean([float(m["total_loss"]) for m in per_batch]),
                                                rel=1e-9)
    # the best checkpoint is the step with the lowest l1, the monitored key
    l1 = {s: m["l1"] for s, _, _, m in vals}
    best_step = min(l1, key=l1.get)
    best = torch.load(os.path.join(work_dir, ckpt.BEST), weights_only=True)
    assert best["global_step"] == best_step and best["best_val"] == pytest.approx(l1[best_step])
    assert ckpt.read_extras(os.path.join(work_dir, "model_ckpt_steps_1.ckpt")) == {"best_val": l1[1]}
    assert [os.path.basename(p) for p in ckpt.get_all_ckpts(work_dir)] == [
        "model_ckpt_steps_2.ckpt", "model_ckpt_steps_1.ckpt"]

    evals.clear()
    trainer, task = _main(tmp_path, monkeypatch, "--hparams", "max_updates=3")
    assert trainer.global_step == task.step == 3 and [h["step"] for h in trainer.history] == [3]
    assert not any(e[1] for e in evals)  # no sanity pass on resume
    assert trainer.best_val == min(l1[best_step], evals[-1][3]["l1"])
    assert task.cfg["hidden_size"] == 16  # the saved config.yaml was read back

    seen = []
    after = DictTTSTask.after_test_step

    def spy(self, i, batch, out):
        seen.append((np.asarray(batch["word_tokens"]), out["pinyin_pred"]))
        return after(self, i, batch, out)

    monkeypatch.setattr(DictTTSTask, "after_test_step", spy)
    trainer, task = _main(tmp_path, monkeypatch, "--infer")
    assert trainer.global_step == 3 and len(seen) == 18
    with open(os.path.join(work_dir, "generated", "meta.csv"), newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == HEADER and len(rows) == 19
    with open(os.path.join(corpus, "pinyin_encoder.pkl"), "rb") as f:
        pinyin = pickle.load(f)
    words = TokenTextEncoder.from_json(os.path.join(corpus, "word_set.json"))
    for row, (wt, pred) in zip(rows[1:], seen):
        n_words = int((wt[0] > 0).sum())
        want = " ".join(jper.decode_pinyin_ids(pred[0], n_words - 2, pinyin))
        assert row[3] == want and len(row[3].split(" ")) == 2 * (n_words - 2) > 0
        assert os.path.exists(os.path.join(work_dir, "generated", f"{row[1]}.mel.npy"))
        assert wt[0][0] == words.token_to_id["<BOS>"]
    assert tper.load_meta_predictions(os.path.join(work_dir, "generated", "meta.csv")) == \
        jper.load_meta_predictions(os.path.join(work_dir, "generated", "meta.csv"))


def test_run_refuses_a_missing_corpus_and_unported_tasks(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="binary_data_dir"):
        _main(tmp_path, monkeypatch, "--hparams", f"binary_data_dir={tmp_path}")
    # a task of the JAX package, named through --hparams, is refused before any data is read
    jax_task = "dicttts_tpu.train.tasks.fs2.FastSpeech2Task"
    with pytest.raises(NotImplementedError, match=jax_task.replace(".", r"\.")):
        _main(tmp_path, monkeypatch, "--reset", "--hparams", f"task_cls={jax_task}")
    # tts/base.yaml names the port's FastSpeech2 task, which trains
    tts_base = os.path.join(CONFIG_ROOT, "tts", "base.yaml")
    hp = (f"binary_data_dir={corpus_dir(tmp_path)},hidden_size=16,enc_layers=1,dec_layers=1,"
          "max_updates=1,val_check_interval=1,num_sanity_val_steps=0,max_frames=256,"
          "mel_buckets=[128 256],max_sentences=5")
    monkeypatch.chdir(tmp_path)
    trainer, task = run.main(["--config", tts_base, "--exp_name", "fs2_base", "--device", "cpu",
                              "--hparams", hp])
    assert isinstance(task, FastSpeech2Task) and trainer.global_step == task.step == 1
    assert np.isfinite(float(trainer.metrics["total_loss"]))


def corpus_dir(root):
    """The repo's valid split as the train, valid and test splits of a
    corpus in ``root``/fs_corpus, with its vocabularies."""
    out = os.path.join(str(root), "fs_corpus")
    os.makedirs(out, exist_ok=True)
    for f in ("word_set.json", "phone_set.json", "spk_map.json"):
        shutil.copy(os.path.join(CORPUS, f), out)
    for split in ("train", "valid", "test"):
        for ext in (".data", ".idx", "_lengths.npy"):
            shutil.copy(os.path.join(CORPUS, "valid" + ext), os.path.join(out, split + ext))
    return out


def _write(path, rows):
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)


def test_per_scoring_matches_the_jax_package(tmp_path):
    meta, labels = str(tmp_path / "meta.csv"), str(tmp_path / "labels.csv")
    _write(meta, [HEADER, [0, "a", "你好", "n i3 h ao3", "a.wav", ""],
                  [1, "b", "好的", "h ao4 <UNK> <UNK> d e5", "b.wav", ""],
                  [2, "c", "爱", " ai4", "c.wav", ""]])
    _write(labels, [["id", "name", "x", "text", "ph"],
                    ["0", "a", "", "你好", "<BOS> n i3 | h ao3 <EOS>"],
                    ["1", "b", "", "好的", "<BOS> h ao3 # d e5 <EOS>"],
                    ["2", "c", "", "爱", "<BOS> ai4 <EOS>"]])
    assert tper.pron_error_rate_files(meta, labels) == jper.pron_error_rate_files(meta, labels)
    assert tper.load_label_set(labels) == jper.load_label_set(labels)
    assert tper.load_meta_predictions(meta) == jper.load_meta_predictions(meta)
    names = str(tmp_path / "names.csv")
    _write(names, [["a", "", "ni3 hao3"], ["b", "", "hao4 de5"]])
    preds = {"a": ["ni3", "hao3"], "b": ["hao3", "de5"]}
    assert tper.load_labels(names) == jper.load_labels(names)
    assert tper.pron_error_rate(preds, tper.load_labels(names)) == \
        jper.pron_error_rate(preds, jper.load_labels(names))
    rng = np.random.RandomState(0)
    pred = rng.randint(0, 12, (9, 2))
    vocab = ["<pad>", "<UNK>", "", "a1"] + [f"p{i}" for i in range(6)]
    assert tper.decode_pinyin_ids(pred, 7, vocab) == jper.decode_pinyin_ids(pred, 7, vocab)
    assert tper.merge_token_pairs(["", "a1", "b", "o2"]) == jper.merge_token_pairs(["", "a1", "b", "o2"])


def test_checkpoint_best_and_partial_load(tmp_path):
    layer = torch.nn.Linear(3, 2)
    state = {"params_g": layer.state_dict(), "step": 4}
    for step, best in ((1, True), (2, False), (3, False)):
        ckpt.save_checkpoint(str(tmp_path), step, state, keep=2, is_best=best,
                             extra={"best_val": float(step)})
    assert sorted(os.listdir(tmp_path)) == [ckpt.BEST, "model_ckpt_steps_2.ckpt",
                                            "model_ckpt_steps_3.ckpt"]  # best survives rotation
    assert ckpt.read_extras(str(tmp_path / ckpt.BEST)) == {"best_val": 1.0}
    assert ckpt.load_checkpoint(str(tmp_path / ckpt.BEST))[0] == 1
    wider = torch.nn.Linear(3, 4)  # weight and bias change shape: both kept
    same = torch.nn.Linear(3, 2)
    out, skipped = ckpt.load_partial(ckpt.get_last_checkpoint(str(tmp_path)), same.state_dict())
    assert skipped == [] and all(torch.equal(out[k], v) for k, v in layer.state_dict().items())
    target = {**wider.state_dict(), "extra": torch.ones(1)}
    out, skipped = ckpt.load_partial(ckpt.get_last_checkpoint(str(tmp_path)), target)
    assert skipped == ["weight", "bias", "extra"] and out["weight"] is target["weight"]


def test_test_hooks_write_wavs_with_a_vocoder_checkpoint(tmp_path):
    from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
    from dicttts_tpu_torch.vocoders.hifigan import spec2wav

    widths = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=16,
                  resblock_kernel_sizes=[3])
    torch.manual_seed(0)
    vocoder = HifiGanGenerator(**{k: tuple(v) if isinstance(v, list) else v for k, v in widths.items()})
    ckpt.save_checkpoint(str(tmp_path / "hifigan"), 10, {"params_g": vocoder.state_dict()})
    task = DictTTSTask({"work_dir": str(tmp_path / "exp"), "binary_data_dir": CORPUS,
                        "vocoder_ckpt": str(tmp_path / "hifigan"), "audio_sample_rate": 8000, **widths},
                       device="cpu")
    rng = np.random.RandomState(0)
    out = {"mel_out": (rng.randn(1, 40, 80) - 4).astype(np.float32),
           "mel2word": np.array([[1] * 10 + [2] * 20 + [0] * 10]),
           "pinyin_pred": np.array([[[0, 0], [5, 6], [7, 8], [0, 0], [0, 0]]])}
    batch = {"word_tokens": np.array([[3, 9, 10, 1, 0]]), "_meta": [{"item_name": "x", "txt": "a,b"}]}
    task.test_end([task.after_test_step(0, batch, out)])
    gen_dir = tmp_path / "exp" / "generated"
    with open(gen_dir / "meta.csv", newline="") as f:
        rows = list(csv.reader(f))
    with open(os.path.join(CORPUS, "pinyin_encoder.pkl"), "rb") as f:
        pinyin = pickle.load(f)
    assert rows == [HEADER, ["0", "x", "a，b", " ".join(pinyin[i] for i in (5, 6, 7, 8)),
                             str(gen_dir / "x.wav"), ""]]
    np.testing.assert_array_equal(np.load(gen_dir / "x.mel.npy"), out["mel_out"][0, :30])
    import wave
    with wave.open(str(gen_dir / "x.wav")) as w:
        assert w.getframerate() == 8000 and w.getnframes() == 30 * 16
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    want = spec2wav(vocoder.eval(), torch.from_numpy(out["mel_out"][0, :30])).numpy()
    np.testing.assert_array_equal(pcm, (np.clip(want, -1, 1) * 32767).astype("<i2"))
