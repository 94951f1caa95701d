"""The port's PER pipeline end to end on the CPU: ``tools.per_eval.main`` with
``--device cpu`` on the repo's stand-in dictionary (.prod_corpus/zh-dict.json,
its phones and sandhi from tests/per_standin_text.json), tiny widths through
``--hparams``, 2 updates: it builds and binarizes the corpus, trains and
infers through ``python -m dicttts_tpu_torch.run`` subprocesses, scores the
test split and the held-in train sentences, and writes the result JSON;
then ``tools.attn_probe`` runs on the experiment. A pipeline check: random
weights after 2 updates, no quality claimed.
"""

import csv
import json
import math
import os
import shutil

import pytest
import torch

from dicttts_tpu_torch.tools import attn_probe, get_pron_error, per_eval

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("hidden_size=16,fvae_enc_dec_hidden=16,latent_size=4,fvae_enc_n_layers=1,fvae_dec_n_layers=1,"
        "prior_glow_hidden=8,prior_glow_n_blocks=1,mel_disc_hidden_size=8,dur_predictor_layers=1,"
        "amp=False,num_ckpt_keep=1,max_sentences=8,sentence_buckets=[8]")


@pytest.fixture
def experiment():
    exp = f"per_eval_cputest{os.getpid()}"
    yield exp
    shutil.rmtree(os.path.join(REPO, "checkpoints", exp), ignore_errors=True)


def test_per_eval_and_attn_probe_end_to_end(experiment, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the run.py subprocesses: one intra-op thread, as above
    with open(os.path.join(REPO, "tests", "per_standin_text.json"), encoding="utf-8") as f:
        text = per_eval.FixedText(json.load(f))
    root, out = str(tmp_path / "corpus"), str(tmp_path / "per.json")
    tag = experiment[len("per_eval_"):]
    result = per_eval.main(
        ["--dict", os.path.join(REPO, ".prod_corpus", "zh-dict.json"), "--root", root,
         "--test_set", str(tmp_path / "test_set.json"), "--out", out, "--device", "cpu", "--tag", tag,
         "--n_items", "21", "--max_updates", "2", "--hparams", TINY, "--score_train"], text=text)
    with open(out) as f:
        assert json.load(f) == result
    assert result["n_test_items"] == 50 and result["max_updates"] == 2
    assert math.isfinite(result["per_pct"]) and 0 <= result["per_pct"] <= 100
    assert result["provenance"]["corpus"].endswith("(.prod_corpus/zh-dict.json, 7997 entries)")
    assert result["provenance"]["first_pron_baseline_per_pct"] > 0
    assert "error" not in result["train_probe"] and result["breakdown"]["heteronym_slots"] > 100
    assert math.isfinite(result["train_probe"]["per_pct"])
    with open(os.path.join(root, "meta_test.csv"), newline="") as f:
        assert len(list(csv.reader(f))) == 51
    # the committed test set is untouched: this run wrote its own
    assert os.path.exists(tmp_path / "test_set.json")
    capsys.readouterr()
    per = get_pron_error.main(["--pred", os.path.join(root, "meta_test.csv"),
                               "--labels", os.path.join(root, "labels.csv")])
    assert round(100 * per, 3) == result["per_pct"]

    summary = attn_probe.main(["--exp", experiment, "--root", root, "--device", "cpu", "--n", "6"])
    assert summary["step"] == 2 and summary["correct"] + summary["wrong"] > 10
    with open(os.path.join(root, "attn_probe_test.json"), encoding="utf-8") as f:
        rows = json.load(f)
    assert len(rows) == summary["correct"] + summary["wrong"]
    assert all(math.isfinite(r["margin"]) and abs(sum(r["p"]) - 1) < 0.01 for r in rows)
