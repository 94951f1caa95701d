"""The port's evaluation tools (dicttts_tpu_torch.tools) against the JAX
package's scripts (scripts/per_eval.py, get_pron_error.py, pron_inspect.py,
pitch_dtw.py, synth_corpus.py, attn_probe.py), bit for bit on the same
inputs: per_eval's host parts on the repo's stand-in dictionary
(.prod_corpus/zh-dict.json) and on a 400-word ``gen_dictionary``; the CLIs'
printed figures on the same files. Also the text fixture chip_smoke.py
gives per_eval on a machine without jieba (tests/per_standin_text.json),
held to the generator and, on a sample, to jieba.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from dicttts_tpu_torch.eval.per import wer
from dicttts_tpu_torch.text.pinyin import ZhG2P, load_dict, pinyin_to_tone3
from dicttts_tpu_torch.text.sandhi import SandhiProcessor
from dicttts_tpu_torch.tools import attn_probe, get_pron_error, per_eval, pitch_dtw, pron_inspect, synth_corpus
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import get_pron_error as j_get_pron_error  # noqa: E402
import per_eval as j_per_eval  # noqa: E402
import pitch_dtw as j_pitch_dtw  # noqa: E402
import pron_inspect as j_pron_inspect  # noqa: E402
import synth_corpus as j_synth_corpus  # noqa: E402

STANDIN = os.path.join(REPO, ".prod_corpus", "zh-dict.json")
FIXTURE = os.path.join(REPO, "tests", "per_standin_text.json")
N_ITEMS = 10


@pytest.fixture(scope="module")
def small_dict(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dict") / "zh-dict.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(synth_corpus.gen_dictionary(400, seed=3), f, ensure_ascii=False)
    return path


@pytest.fixture(scope="module")
def fixed_text():
    with open(FIXTURE, encoding="utf-8") as f:
        return per_eval.FixedText(json.load(f))


def _corpus(root, dict_path, text, monkeypatch):
    """Both packages' build_per_corpus on ``dict_path``, binarizing skipped
    (the binaries' index files exist): (port, JAX) results and test sets."""
    out = {}
    for side in ("port", "jax"):
        r = os.path.join(root, side)
        bdir = os.path.join(r, f"binary_n{N_ITEMS}_v{per_eval.BANK_VERSION}")
        os.makedirs(bdir)
        for name in ("train.idx", "dict_embed.idx"):
            open(os.path.join(bdir, name), "w").close()
        test_set = os.path.join(r, "test_set.json")
        if side == "port":
            res = per_eval.build_per_corpus(r, N_ITEMS, dict_path, test_set, device="cpu", text=text)
        else:
            monkeypatch.setattr(j_per_eval, "TEST_SET_JSON", test_set)
            res = j_per_eval.build_per_corpus(r, N_ITEMS, dict_path)
        with open(test_set, "rb") as f:
            out[side] = (res, f.read())
    return out


@pytest.mark.parametrize("which", ["standin", "gen_dictionary_400"])
def test_corpus_host_parts_match_jax(which, small_dict, fixed_text, tmp_path, monkeypatch):
    dict_path = STANDIN if which == "standin" else small_dict
    zd = load_dict(dict_path)
    het, single = per_eval._select_heteronyms(zd, 160)
    assert (het, single) == j_per_eval._select_heteronyms(zd, 160)
    assert len(het) == (160 if which == "standin" else len(het)) and len(het) > 10
    for seed, n in ((per_eval.TEST_SEED, per_eval.N_TEST), (5, 40)):
        assert (per_eval._gen_items(zd, het, np.random.RandomState(seed), n, "t")
                == j_per_eval._gen_items(zd, het, np.random.RandomState(seed), n, "t"))

    # gold, baseline and stats; the stand-in through the fixture, jieba for the other
    out = _corpus(str(tmp_path), dict_path, fixed_text if which == "standin" else None, monkeypatch)
    (bdir, gold, baseline, stats, binarizer), test_set = out["port"]
    (_, j_gold, j_baseline, j_stats), j_test_set = out["jax"]
    assert binarizer is None and test_set == j_test_set
    assert gold == j_gold and baseline == j_baseline
    assert {k: v for k, v in stats.items() if k != "test_set"} == {
        k: v for k, v in j_stats.items() if k != "test_set"}
    assert stats["heteronym_slots"] > 150 and stats["first_pron_heteronym_acc"] < 0.8
    names = sorted(gold)
    assert wer([gold[n] for n in names], [baseline[n] for n in names]) > 0

    syls = [s for n in names for s in gold[n]]
    bank = per_eval._syllable_bank(syls)
    assert bank == j_per_eval._syllable_bank(syls) and len(bank) == stats["distinct_syllables"]
    for n in names[:3] + names[-2:]:
        np.testing.assert_array_equal(per_eval._render(gold[n], bank, 22050, 0.11),
                                      j_per_eval._render(gold[n], bank, 22050, 0.11))


def _split(path, items):
    with IndexedDatasetBuilder(path) as b:
        for name, txt in items:
            b.add_item({"item_name": name, "txt": txt})


def _diag_files(root, fixed_text):
    """Labels of the stand-in's 50 test sentences and a meta.csv whose
    predictions differ at some heteronym slots and one row's length."""
    zd = load_dict(STANDIN)
    het, _ = per_eval._select_heteronyms(zd, 160)
    items = per_eval._gen_items(zd, het, np.random.RandomState(per_eval.TEST_SEED), per_eval.N_TEST, "t")
    gold, _, _ = per_eval.gold_syllables(zd, fixed_text, items)
    _split(os.path.join(root, "test"), [(n, t) for n, t, _ in items])
    rng = np.random.RandomState(0)
    rows = []
    for i, (name, text, choice) in enumerate(items):
        toks = []
        for ch, syl, c in zip(text, gold[name], choice):
            prons = zd.prons(ch)
            if c is not None and rng.rand() < 0.4:  # another reading of a heteronym
                syl = prons[(prons.index(syl) + 1) % len(prons)] if syl in prons else syl
            ini, fin = pinyin_to_tone3(syl)
            toks += [ini, fin]
        if i == 7:
            toks = toks[:-2]  # one syllable short: skipped by the slot diagnostics
        rows.append(f"{i},{name},{text},{' '.join(toks)},p.wav,g.wav")
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", encoding="utf-8") as f:
        f.write(",item_name,text,pinyin_tokens,wav_fn_pred,wav_fn_gt\n" + "\n".join(rows) + "\n")
    return gold, meta


def test_labels_slot_diagnostics_and_scoring_match_jax(fixed_text, tmp_path, capsys, monkeypatch):
    root = str(tmp_path)
    gold, meta = _diag_files(root, fixed_text)
    labels, j_labels = os.path.join(root, "labels.csv"), os.path.join(root, "j_labels.csv")
    assert per_eval.write_labels(root, "test", gold, labels) == 50
    j_per_eval.write_labels(root, "test", gold, j_labels)
    assert open(labels, "rb").read() == open(j_labels, "rb").read()

    diag = per_eval.slot_diagnostics(labels, meta, STANDIN, os.path.join(root, "d.json"), fixed_text)
    j_diag = j_per_eval.slot_diagnostics(labels, meta, STANDIN, os.path.join(root, "j_d.json"))
    assert diag == j_diag
    assert open(os.path.join(root, "d.json"), "rb").read() == open(os.path.join(root, "j_d.json"), "rb").read()
    assert diag["heteronym_errors"] > 10 and diag["rows_skipped_len_mismatch"] == 1

    for argv in (["--pred", meta, "--labels", labels], ["--pred", meta, "--labels", labels, "--show_errors"]):
        per = get_pron_error.main(argv)
        port_out = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["get_pron_error.py", *argv])
        j_get_pron_error.main()
        assert port_out == capsys.readouterr().out
        assert f"| PER: {per * 100:.2f}%" in port_out and 0 < per < 1

    # simple mode: name-keyed 3-column CSVs
    simple = {}
    for side, flip in (("pred", True), ("ref", False)):
        simple[side] = os.path.join(root, f"{side}.csv")
        with open(simple[side], "w", encoding="utf-8") as f:
            for name in sorted(gold)[:20]:
                syls = list(gold[name])
                if flip and name.endswith("3"):
                    syls[0] = "xx1"
                f.write(f"{name},x,{' '.join(syls)}\n")
    argv = ["--pred", simple["pred"], "--labels", simple["ref"], "--simple", "--show_errors"]
    get_pron_error.main(argv)
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["get_pron_error.py", *argv])
    j_get_pron_error.main()
    assert port_out == capsys.readouterr().out and "errors" in port_out


def test_pron_inspect_matches_jax(fixed_text, tmp_path, capsys, monkeypatch):
    root = str(tmp_path)
    gold, meta = _diag_files(root, fixed_text)
    labels = os.path.join(root, "labels.csv")
    per_eval.write_labels(root, "test", gold, labels)
    tsv = os.path.join(root, "labels.tsv")
    with open(tsv, "w", encoding="utf-8") as f:
        for name in sorted(gold):
            f.write(name + "\t" + " ".join(f"字 {pinyin_to_tone3(s)[0] + pinyin_to_tone3(s)[1]}"
                                           for s in gold[name]) + "\n")
    run_b = os.path.join(root, "run_b")
    os.makedirs(run_b)
    with open(meta, encoding="utf-8") as f, open(os.path.join(run_b, "meta.csv"), "w", encoding="utf-8") as g:
        g.write(f.read().replace(" a1 ", " a2 "))
    for lab in (labels, tsv):
        argv = [meta, run_b, "--labels", lab, "--dict_path", STANDIN, "--show_all"]
        summaries = pron_inspect.main(argv)
        port_out = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["pron_inspect.py", *argv])
        j_pron_inspect.main()
        assert port_out == capsys.readouterr().out
        assert summaries[0]["heteronyms"] > 100 and summaries[0]["syllable_errors"] > 0
    assert pron_inspect.load_tsv_labels(tsv) == j_pron_inspect.load_tsv_labels(tsv)


def test_pitch_dtw_matches_jax(tmp_path, capsys, monkeypatch):
    rng = np.random.RandomState(0)
    gen, gt = tmp_path / "gen", tmp_path / "gt"
    gen.mkdir()
    gt.mkdir()
    for i in range(4):
        f0 = np.where(rng.rand(40) < 0.2, 0.0, 120 + 30 * rng.rand(40)).astype(np.float32)
        np.save(gen / f"u{i}.f0.npy", f0)
        if i != 2:  # one item without ground truth
            np.save(gt / f"u{i}.f0.npy", np.roll(f0, i) * (1 + 0.05 * i))
    argv = ["--gen_dir", str(gen), "--gt_dir", str(gt)]
    mean = pitch_dtw.main(argv)
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["pitch_dtw.py", *argv])
    j_pitch_dtw.main()
    assert port_out == capsys.readouterr().out
    assert "over 3 items" in port_out and mean > 0


def test_gen_dictionary_and_mark_tone_match_jax():
    for seed in (0, 7):
        assert synth_corpus.gen_dictionary(400, seed) == j_synth_corpus.gen_dictionary(400, seed)
    for syl in ("ban", "liu", "gui", "nve", "er", "m"):
        for tone in (1, 2, 3, 4):
            assert synth_corpus.mark_tone(syl, tone) == j_synth_corpus.mark_tone(syl, tone)


def test_build_corpus_pre_align_matches_jax(tmp_path):
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(n_words=40, n_items=10, seed=2, min_chars=6, max_chars=12)
    j_synth_corpus.build_corpus(jax_root, binarize=False, **kw)
    bdir = synth_corpus.build_corpus(port_root, extra_cfg={"dict_embed_dim": 16}, device="cpu", **kw)
    for name in ("zh-dict.json", "processed/metadata_phone.csv", "processed/phone_set.json",
                 "processed/word_set.json"):
        got = open(os.path.join(port_root, name), "rb").read()
        want = open(os.path.join(jax_root, name), "rb").read()
        assert got == want.replace(jax_root.encode(), port_root.encode()), name
    for split, n in (("test", 4), ("valid", 4), ("train", 2)):
        assert len(np.load(os.path.join(bdir, f"{split}_lengths.npy"))) == n


def test_standin_fixture_matches_generator_and_jieba(fixed_text):
    table = fixed_text.table
    zd = load_dict(os.path.join(REPO, table["dict"]))
    het, _ = per_eval._select_heteronyms(zd, 160)
    items = (per_eval._gen_items(zd, het, np.random.RandomState(per_eval.TEST_SEED), per_eval.N_TEST, "t")
             + per_eval._gen_items(zd, het, np.random.RandomState(0), table["n_items"], "h"))
    texts = [t for _, t, _ in items]
    assert sorted(table["g2p"]) == sorted(set(texts)) and table["n_items"] == 300
    norms = {e["norm"] for e in table["g2p"].values()}
    assert set(table["sandhi"]) == set(texts) | norms
    g2p, sandhi = ZhG2P(os.path.join(REPO, table["dict"]), pos_merge=True), SandhiProcessor(zd)
    for i in np.random.RandomState(1).choice(len(texts), 6, replace=False):
        ph, norm = g2p.process(texts[i])
        assert fixed_text.process(texts[i]) == (ph, norm)
        assert fixed_text.process_sandhi(texts[i]) == sandhi.process_sandhi(texts[i])
    with pytest.raises(KeyError, match="no precomputed"):
        fixed_text.process("天地")


def _stats_reference(w, sense_ids):
    """scripts/attn_probe.py's per-slot loop (:109-124)."""
    masses = []
    for s in range(1, int(sense_ids.max()) + 1):
        sel = sense_ids == s
        masses.append(float(w[sel].mean()) if sel.any() else 0.0)
    if not masses or sum(masses) <= 0:
        return None
    p = np.asarray(masses) / sum(masses)
    srt = np.sort(p)[::-1]
    margin = float(srt[0] - (srt[1] if len(srt) > 1 else 0.0))
    ent = float(-(p * np.log(np.maximum(p, 1e-9))).sum() / np.log(max(len(p), 2)))
    return int(np.argmax(p)), p, margin, ent, float(p.max())


def test_slot_sense_stats_on_hand_made_slots():
    P = 6
    w = np.asarray([
        [0.5, 0.3, 0.1, 0.1, 0.0, 0.0],  # two readings, the first sharp
        [0.2, 0.2, 0.3, 0.3, 0.0, 0.0],  # two readings, the second ahead
        [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],  # a tie: the first reading wins
        [0.6, 0.4, 0.0, 0.0, 0.0, 0.0],  # one reading: margin is its p (1)
        [0.1, 0.2, 0.3, 0.1, 0.2, 0.1],  # three readings, reading 2 without tokens
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # no mass: not a slot
        [0.3, 0.3, 0.2, 0.2, 0.0, 0.0],  # padding only: not a slot
    ])
    ids = np.asarray([
        [1, 1, 2, 2, 0, 0], [1, 1, 2, 2, 0, 0], [1, 1, 2, 2, 0, 0], [1, 1, 0, 0, 0, 0],
        [1, 1, 3, 3, 3, 0], [1, 1, 2, 2, 0, 0], [0, 0, 0, 0, 0, 0]])
    got = {k: v.numpy() for k, v in attn_probe.slot_sense_stats(torch.tensor(w, dtype=torch.float32)[None],
                                                                  torch.tensor(ids)[None]).items()}
    assert got["p"].shape == (1, 7, 3)
    for i in range(len(w)):
        ref = _stats_reference(w[i].astype(np.float32), ids[i])
        assert bool(got["valid"][0, i]) == (ref is not None), i
        if ref is None:
            continue
        pred, p, margin, ent, top = ref
        n = int(got["n_senses"][0, i])
        assert n == len(p) and int(got["pred"][0, i]) == pred, i
        np.testing.assert_allclose(got["p"][0, i, :n], p, rtol=1e-6, err_msg=str(i))
        assert not got["p"][0, i, n:].any()
        np.testing.assert_allclose([got["margin"][0, i], got["entropy"][0, i], got["top_p"][0, i]],
                                   [margin, ent, top], rtol=1e-6, atol=1e-7, err_msg=str(i))
    np.testing.assert_allclose(got["margin"][0, 3], 1.0)
    assert int(got["pred"][0, 2]) == 0 and got["p"][0, 4, 1] == 0.0
    assert got["p"].shape[-1] == 3 and P == w.shape[1]
