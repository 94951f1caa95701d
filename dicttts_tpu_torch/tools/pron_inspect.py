"""Pronunciation-error inspection across experiment runs.

Counterpart of ``scripts/pron_inspect.py`` (the reference's
``utils/pron_utils.py`` usage): compare one or more test-run output dirs
(each holding the ``meta.csv`` that ``--infer`` writes) against a label
file, printing every mismatched utterance (predicted vs gold syllables),
then per-run totals and heteronym density.

Label formats (detected from the first line):
  - ``label_set0.csv``, the reference's CSV (header; column 4 the phone
    string), as ``tools/get_pron_error.py`` reads it;
  - TSV, ``wav_id<TAB><char py char py ...>`` alternating characters and
    pinyin: the odd-index tokens are the syllables, tone-5 marks stripped.

Heteronyms are the characters with more than one reading in the
dictionary the model uses (the reference counts pypinyin readings).

    python -m dicttts_tpu_torch.tools.pron_inspect --labels data/pron_label/label_set0.csv \\
        checkpoints/exp_a/generated checkpoints/exp_b/generated

Host-only.
"""

from __future__ import annotations

import argparse
import csv
import os

from dicttts_tpu_torch.eval.per import edit_distance, load_label_set, merge_token_pairs


def _strip_tone5(syl: str) -> str:
    return syl[:-1] if syl.endswith("5") else syl


def load_tsv_labels(path: str) -> tuple[list[list[str]], list[str]]:
    """pron_utils.get_label format -> (gold syllable lists, wav_ids)."""
    gold, ids = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            wav_id, content = line.split("\t")[0], line.split("\t")[1].split(" ")
            gold.append([_strip_tone5(content[i]) for i in range(len(content)) if i % 2 == 1])
            ids.append(wav_id)
    return gold, ids


def load_any_labels(path: str) -> tuple[list[list[str]], list[str]]:
    with open(path, encoding="utf-8") as f:
        head = f.readline()
    if "\t" in head:
        return load_tsv_labels(path)
    gold = load_label_set(path)
    return gold, [str(i) for i in range(len(gold))]


def load_meta_rows(meta_csv: str) -> list[dict]:
    """meta.csv -> [{name, text, syllables}] (eval/per.py's parsing, the
    text column kept for heteronym counting)."""
    rows = []
    with open(meta_csv, encoding="utf-8") as f:
        lines = f.readlines()
    for line in lines[1:]:
        parts = next(csv.reader([line]))
        if len(parts) < 4:
            continue
        toks = parts[3].replace("<UNK> ", "").strip().split(" ")
        rows.append({"name": parts[1], "text": parts[2], "syllables": merge_token_pairs(toks)})
    return rows


def heteronym_count(text: str, zh_dict) -> int:
    """Characters with more than one dictionary reading."""
    if zh_dict is None:
        return 0
    return sum(1 for ch in text if len(zh_dict.prons(ch)) > 1)


def inspect_run(run: str, gold: list[list[str]], ids: list[str], zh_dict, show_all: bool) -> dict:
    meta = run if run.endswith(".csv") else os.path.join(run, "meta.csv")
    rows = load_meta_rows(meta)
    n = min(len(rows), len(gold))
    total_err = total_syl = total_het = n_bad = 0
    for i in range(n):
        pred, ref = rows[i]["syllables"], gold[i]
        d = edit_distance(ref, pred)
        het = heteronym_count(rows[i]["text"], zh_dict)
        total_err += d
        total_syl += len(ref)
        total_het += het
        if d:
            n_bad += 1
            print(f"[{run}] {ids[i] if i < len(ids) else i} ({rows[i]['name']}): "
                  f"{d} errors, {het} heteronyms")
            print(f"  ref: {' '.join(ref)}")
            print(f"  hyp: {' '.join(pred)}")
        elif show_all:
            print(f"[{run}] {ids[i] if i < len(ids) else i}: ok ({het} heteronyms)")
    per = total_err / max(total_syl, 1)
    return {
        "run": run, "items": n, "items_with_errors": n_bad,
        "syllable_errors": total_err, "syllables": total_syl,
        "heteronyms": total_het,
        "per_pct": round(100.0 * per, 3),
        "err_per_heteronym": round(total_err / max(total_het, 1), 4),
    }


def main(argv=None) -> list[dict]:
    """Run the command line ``argv``; returns each run's summary."""
    p = argparse.ArgumentParser()
    p.add_argument("runs", nargs="+", help="test-output dirs (or meta.csv paths) to compare")
    p.add_argument("--labels", required=True, help="label_set0.csv or wav_id-TSV label file")
    p.add_argument("--dict_path", default="data/zh-dict.json", help="for heteronym counting")
    p.add_argument("--show_all", action="store_true")
    args = p.parse_args(argv)

    zh_dict = None
    if os.path.exists(args.dict_path):
        from dicttts_tpu_torch.text.pinyin import load_dict

        zh_dict = load_dict(args.dict_path)

    gold, ids = load_any_labels(args.labels)
    summaries = [inspect_run(r, gold, ids, zh_dict, args.show_all) for r in args.runs]
    print("\n| run | items | err items | PER% | heteronyms | err/het |")
    for s in summaries:
        print(f"| {s['run']} | {s['items']} | {s['items_with_errors']} | "
              f"{s['per_pct']} | {s['heteronyms']} | {s['err_per_heteronym']} |")
    return summaries


if __name__ == "__main__":
    main()
