"""Pronunciation error rate (PER), the paper's metric, in the reference format.

Port of ``dicttts_tpu/eval/per.py`` (host-only Python):

- Labels: a CSV with a header; column 3 is the text, column 4 the phone
  string ``<BOS> k a3 | er3 | p u3 # p ei2 ... <EOS>``, parsed into one
  syllable per character ("ka3", "er3", ...).
- Predictions: ``meta.csv`` column 3 (``pinyin_tokens``), two pinyin tokens
  per character (the initial may be the empty string; ``<UNK>`` for pad or
  missing rows). Scoring drops ``'<UNK> '`` and merges consecutive token
  pairs into syllables.
- PER = word error rate of (predictions, labels), with the predictions in
  the first ("truth") argument as the reference scorer passes them, so the
  denominator is the predicted syllable count.
"""

from __future__ import annotations

import csv
import re


def edit_distance(ref: list[str], hyp: list[str]) -> int:
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def wer(refs: list[list[str]], hyps: list[list[str]]) -> float:
    """Corpus-level word error rate (jiwer.wer semantics: total edit
    distance over total reference length)."""
    total_err = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    total_len = sum(len(r) for r in refs)
    return total_err / max(total_len, 1)


def merge_token_pairs(tokens: list[str]) -> list[str]:
    """Merge (initial, final) token pairs into syllables (i%2 pairing;
    empty-string initials concatenate away)."""
    out, pron = [], ""
    for i, item in enumerate(tokens):
        if i % 2 == 0:
            pron = item
        else:
            out.append(pron + item)
            pron = ""
    return out


def decode_pinyin_ids(pinyin_pred_row, n_chars: int, pinyin_list) -> list[str]:
    """[T_w, 2] argmax id pairs -> flat token strings for the real chars
    (rows 1..n_chars, skipping BOS/EOS). Pad id 0 renders as '<UNK>'
    exactly like the reference vocab (pinyin_encoder[0] == '<UNK>',
    stripped by the scorer); out-of-vocab ids render as '?'. The single
    decode convention shared by the test scaffold (meta.csv) and the
    serving path."""
    toks = []
    for pair in pinyin_pred_row[1 : n_chars + 1]:
        for i in pair:
            i = int(i)
            toks.append(
                "<UNK>" if i == 0 else pinyin_list[i] if i < len(pinyin_list) else "?"
            )
    return toks


def parse_label_ph(ph: str) -> list[str]:
    """``<BOS> k a3 | er3 # p ei2 <EOS>`` -> ["ka3", "er3", "pei2"]."""
    core = ph[6:-6]  # strip '<BOS> ' and ' <EOS>' (reference [6:-6])
    return [item.replace(" ", "") for item in re.split(r" \| | \# ", core)]


def load_label_set(label_csv: str) -> list[list[str]]:
    """Reference label_set0.csv (header; col 3 txt, col 4 ph) -> gold
    syllable lists, in file order."""
    gold = []
    with open(label_csv, encoding="utf-8") as f:
        lines = f.readlines()
    for line in lines[1:]:
        parts = line.split(",")
        if len(parts) < 5:
            continue
        gold.append(parse_label_ph(parts[4]))
    return gold


def load_meta_predictions(meta_csv: str) -> list[list[str]]:
    """meta.csv (header; col 3 pinyin_tokens) -> predicted syllable lists.

    Reference parsing (get_pron_error.py:30-43): strip '<UNK> ' occurrences,
    split on single spaces (empty-string initials survive as '' items), then
    pair-merge."""
    preds = []
    with open(meta_csv, encoding="utf-8") as f:
        lines = f.readlines()
    for line in lines[1:]:
        pron_label = line.split(",")[3].replace("<UNK> ", "").replace("\n", "").split(" ")
        preds.append(merge_token_pairs(pron_label))
    return preds


def pron_error_rate_files(meta_csv: str, label_csv: str) -> float:
    """The reference's headline number: PER over aligned file rows.

    Mirrors ``wer(pred, gold)`` from get_pron_error.py:48 — predictions as
    the first (truth) argument."""
    pred = load_meta_predictions(meta_csv)
    gold = load_label_set(label_csv)
    n = min(len(pred), len(gold))
    assert n > 0, "no rows to score"
    return wer(pred[:n], gold[:n])


# -- name-keyed scoring, for ad-hoc evaluation ---------------------------------


def load_labels(label_csv: str) -> dict[str, list[str]]:
    """item_name -> per-char pinyin tokens (simple 3-column format)."""
    out = {}
    with open(label_csv, encoding="utf-8") as f:
        for row in csv.reader(f):
            if len(row) >= 3:
                out[row[0]] = row[2].strip().split()
    return out


def pron_error_rate(predictions: dict[str, list[str]], labels: dict[str, list[str]]) -> float:
    """predictions/labels: item_name -> pinyin token list. Items present in
    both are scored; PER = corpus WER."""
    refs, hyps = [], []
    for name, ref in labels.items():
        if name in predictions:
            refs.append(ref)
            hyps.append(predictions[name])
    assert refs, "no overlapping items between predictions and labels"
    return wer(refs, hyps)
