"""``python -m dicttts_tpu_torch.run`` under two gloo ranks on the CPU, as
``torchrun --nproc_per_node=2`` starts it, then ``--infer`` through
``--multihost``'s DICTTTS_* variables (``tests/torch_ddp_workers.py``),
against the same command lines in one process.

On tests/test_torch_run.py's toy corpus cut to 15 utterances, 4 sentences
a batch: batches of 4, 4, 4 and 3 sentences, the last padded with a zero
row for rank 1. Four steps (one epoch, the padded batch included) with a
validation and a checkpoint every two, a resume to step 5, and
``--infer``. Dropout is 0 and both sides run with
``torch_ddp_workers.pinned_draws``, so every step draws the same noise and
crop starts on two ranks as in one process.

Checked: both ranks step together on the same batches as one process,
report the same validation means and end with the same weights; the
validation means equal one process's (rtol 1e-5 / atol 1e-6) after the
training and after the resume; the last checkpoint's weights equal one
process's within atol 1e-6 plus the Adam term of every update taken
(``torch_ddp_workers.update_atol``, as tests/test_torch_ddp.py); rank 0
alone writes checkpoints and the test outputs; the resume continues from
the saved step; and the two ranks' ``meta.csv`` equals the one a single
process writes from the same checkpoint. The process groups are gone after
each run.

At the config's ``steps_per_dispatch`` (16) the two ranks form the same
groups of those batches, the odd shape re-queued and the validation marks
ending groups, and end bit for bit where the same two ranks end at one
step a group: the last checkpoint and the validation means.
"""

import csv
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_ddp_workers as W  # noqa: E402
from test_torch_run import RECIPE, SMALL, corpus  # noqa: E402,F401  (corpus: the fixture)

from dicttts_tpu_torch import run  # noqa: E402
from dicttts_tpu_torch.parallel import mesh  # noqa: E402
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask  # noqa: E402
from dicttts_tpu_torch.config import load_config  # noqa: E402
from dicttts_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset, IndexedDatasetBuilder  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

N_ITEMS = 15  # batches of 4, 4, 4, 3: the last is not a multiple of two ranks


@pytest.fixture(scope="module")
def odd_corpus(corpus, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("odd_corpus")
    splits = ("train", "valid", "test")
    for f in os.listdir(corpus):
        if not f.startswith(splits):
            shutil.copy(os.path.join(corpus, f), root)
    src = IndexedDataset(os.path.join(corpus, "valid"))
    lengths = np.load(os.path.join(corpus, "valid_lengths.npy"))
    for split in splits:
        with IndexedDatasetBuilder(str(root / split)) as b:
            for i in range(N_ITEMS):
                b.add_item(src[i])
        np.save(root / f"{split}_lengths.npy", lengths[:N_ITEMS])
    src.close()
    return str(root)


def _meta(work):
    with open(os.path.join(work, "checkpoints", "toy", "generated", "meta.csv"), newline="") as f:
        return list(csv.reader(f))


def _last_params(work) -> dict:
    step, state = ckpt.load_checkpoint(ckpt.get_all_ckpts(str(work / "checkpoints" / "toy"))[0])
    return step, {**{f"0.{k}": v for k, v in state["params_g"].items()},
                  **{f"1.{k}": v for k, v in state["params_d"].items()}}


def _one_process(work, hparams, monkeypatch):
    """The same command lines in this process, with the same pinned draws;
    per run its validation means and best value, and the Adam term of
    every update, summed."""
    pinned = W.pinned_draws(DictTTSTask)
    atol: dict = {}

    def train_step(self, batch, generator=None, **kw):
        metrics = pinned["train_step"](self, batch, generator, **kw)
        for k, v in W.update_atol(self, (self.model, self.disc)).items():
            atol[k] = atol.get(k, 0.0) + v
        return metrics

    monkeypatch.setattr(DictTTSTask, "train_step", train_step)
    monkeypatch.setattr(DictTTSTask, "val_step", pinned["val_step"])
    monkeypatch.setattr(DictTTSTask, "_forward", pinned["_forward"])
    monkeypatch.chdir(work)
    runs = []
    for hp in hparams:
        trainer, _ = run.main(["--config", RECIPE, "--exp_name", "toy", "--device", "cpu", "--hparams", hp])
        runs.append({"step": trainer.global_step, "history": [h["sentences"] for h in trainer.history],
                     "val": dict(trainer.val_metrics), "best_val": trainer.best_val})
    monkeypatch.undo()
    return runs, atol


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")


def test_two_ranks_train_resume_and_infer(odd_corpus, tmp_path, monkeypatch):
    work, one_work = tmp_path / "work", tmp_path / "one"
    work.mkdir()
    one_work.mkdir()
    # one step a group: the checkpoints below are the validation marks' own (with the config's groups
    # of 16, a re-queued batch at a mark joins the next one and validates a step late, as in JAX)
    hp = (f"binary_data_dir={odd_corpus},max_updates=4,val_check_interval=2,num_sanity_val_steps=1,"
          f"valid_monitor_key=l1,{SMALL},max_sentences=4,dropout=0.0,predictor_dropout=0.0,disc_dropout=0.0,"
          "steps_per_dispatch=1")
    hparams = [hp, "max_updates=5"]
    ports = [W.free_port() for _ in range(3)]
    ranks = W.spawn(tmp_path / "out", W.run_main_ranks, str(work), ports, RECIPE, [*hparams, None],
                    group=False)
    (train0, resume0, infer0), (train1, resume1, infer1) = ranks[0]["runs"], ranks[1]["runs"]
    for t in (train0, train1):
        assert t["step"] == t["task_step"] == 4 and t["history"] == [4, 4, 4, 3]
    for r in (resume0, resume1):
        assert r["step"] == r["task_step"] == 5 and r["history"] == [4]
    for a, b in ((train0, train1), (resume0, resume1)):
        assert a["val"] == b["val"] and a["best_val"] == b["best_val"] and a["checksum"] == b["checksum"]
    # rank 0 alone writes: the checkpoints at steps 2 and 4, then 5; the test outputs (15 batches)
    assert train0["written"] == [2, 4] and resume0["written"] == [5]
    assert train1["written"] == resume1["written"] == infer1["written"] == []
    assert infer0["test_end"] == [N_ITEMS] and infer1["test_end"] == []
    assert infer0["step"] == 5 and not any(r["initialized_after"] for r in (*ranks[0]["runs"], *ranks[1]["runs"]))
    work_dir = work / "checkpoints" / "toy"
    assert [os.path.basename(p) for p in ckpt.get_all_ckpts(str(work_dir))] == [
        f"model_ckpt_steps_{s}.ckpt" for s in (5, 4, 2)]
    assert ckpt.read_extras(str(work_dir / "model_ckpt_steps_5.ckpt")) == {"best_val": resume0["best_val"]}
    two_ranks = _meta(work)
    assert len(two_ranks) == N_ITEMS + 1

    # one process on the same batches: the validation means and the last weights
    (one_train, one_resume), atol = _one_process(one_work, hparams, monkeypatch)
    assert one_train["step"] == 4 and one_train["history"] == [4, 4, 4, 3]
    assert one_resume["step"] == 5 and one_resume["history"] == [4]
    for got, want, what in ((train0, one_train, "validation after training"),
                            (resume0, one_resume, "validation after the resume")):
        _close(got["val"], want["val"], what)
        np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=1e-5, atol=1e-6)
    (step, got), (one_step, want) = _last_params(work), _last_params(one_work)
    assert step == one_step == 5 and set(got) == set(want) and set(atol) <= set(want)
    for k, v in want.items():  # buffers: no update, so atol 1e-6
        err = (got[k] - v).abs().numpy()
        assert (err <= 1e-6 + atol.get(k, 0.0)).all(), (k, float(err.max()))

    # one process --infers from the two ranks' checkpoint
    monkeypatch.chdir(work)
    trainer, _ = run.main(["--config", RECIPE, "--exp_name", "toy", "--device", "cpu", "--infer"])
    assert trainer.global_step == 5 and not mesh.initialized()
    assert _meta(work) == two_ranks


def test_two_ranks_group_at_the_configs_steps_per_dispatch(odd_corpus, tmp_path):
    """The config's K against K = 1, two gloo ranks each, the trainer's own
    draws (a function of the step, whatever the groups): the same batches
    in groups, the same last step, state and validation means, bit for
    bit. The first batch's shape is the odd one: it runs alone, and the
    mark at step 2 validates and checkpoints at the end of the group that
    holds it, step 3, as the JAX trainer does."""
    assert load_config(RECIPE)["steps_per_dispatch"] == 16
    work = tmp_path / "work"
    work.mkdir()
    hp = (f"binary_data_dir={odd_corpus},max_updates=4,val_check_interval=2,num_sanity_val_steps=0,"
          f"valid_monitor_key=l1,{SMALL},max_sentences=4,dropout=0.0,predictor_dropout=0.0,disc_dropout=0.0")
    ports = [W.free_port() for _ in range(2)]
    ranks = W.spawn(tmp_path / "out", W.run_main_ranks, str(work), ports, RECIPE, [hp, hp + ",steps_per_dispatch=1"],
                    ["grouped", "single"], False, group=False)
    (grouped0, single0), (grouped1, single1) = ranks[0]["runs"], ranks[1]["runs"]
    for a, b in ((grouped0, grouped1), (single0, single1)):
        assert a["step"] == b["step"] == 4 and a["history"] == b["history"] == [4, 4, 4, 3]
        assert a["groups"] == b["groups"] and a["checksum"] == b["checksum"] and a["val"] == b["val"]
    assert [size for _, size in single0["groups"]] == [1, 1, 1, 1]
    assert grouped0["groups"] == [(0, 1), (1, 2), (1, 2), (2, 1)]
    assert grouped0["val"] == single0["val"] and grouped0["checksum"] == single0["checksum"]
    assert grouped0["written"] == [3, 4] and single0["written"] == [2, 4] and grouped1["written"] == []
    last = [ckpt.load_checkpoint(ckpt.checkpoint_path(str(work / "checkpoints" / name), 4))[1]
            for name in ("grouped", "single")]
    assert ckpt.bit_differences(*last) == []
