"""Montreal Forced Aligner driver (offline, host side).

Port of ``dicttts_tpu/text/mfa.py``: write MFA's inputs (wav and .lab pairs
in groups of subdirectories), the pronunciation lexicon (every dictionary
reading of every character), and run an ``mfa`` binary through
``subprocess`` when one is installed (``mfa_available()``). MFA and its
acoustic models are not part of this project; the binarizer reads the
TextGrids it writes, or aligns uniformly without them.
"""

from __future__ import annotations

import csv
import logging
import os
import shutil
import subprocess

from dicttts_tpu_torch.text.pinyin import load_dict, pinyin_to_tone3

log = logging.getLogger("dicttts_tpu_torch.mfa")


def mfa_available() -> bool:
    return shutil.which("mfa") is not None


def build_mfa_lexicon(cfg: dict, out_fn: str):
    """Word -> space-separated phones, one line per (word, pronunciation):
    every dictionary reading of every vocab char is expanded (heteronym
    coverage for alignment)."""
    zh_dict = load_dict(cfg.get("dict_path", "data/zh-dict.json"))
    with open(out_fn, "w", encoding="utf-8") as f:
        for char, prons in zh_dict.entries.items():
            for pron in prons:
                initial, final = pinyin_to_tone3(pron)
                phones = " ".join(p for p in (initial, final) if p)
                if phones:
                    f.write(f"{char}\t{phones}\n")


def prepare_mfa_inputs(cfg: dict, group_size: int = 100):
    """Group (wav, .lab transcript) pairs into mfa_inputs/<group>/
    (upstream base_pre_align.py:182-189)."""
    proc = cfg["processed_data_dir"]
    rows = list(csv.reader(open(os.path.join(proc, "metadata_phone.csv"))))
    in_dir = os.path.join(proc, "mfa_inputs")
    for i, row in enumerate(rows):
        item_name, wav_fn, _, ph_str = row[0], row[1], row[2], row[3]
        group = os.path.join(in_dir, f"{i // group_size:03d}")
        os.makedirs(group, exist_ok=True)
        if os.path.exists(wav_fn):
            dst = os.path.join(group, f"{item_name}.wav")
            if not os.path.exists(dst):
                shutil.copy(wav_fn, dst)
        with open(os.path.join(group, f"{item_name}.lab"), "w", encoding="utf-8") as f:
            f.write(" ".join(p for p in ph_str.split() if p not in ("#", "|")))
    return in_dir


def mfa_train_and_align(cfg: dict):
    """Train a fresh aligner on the corpus and align (upstream
    mfa_train.py + mfa_align.py flow). Requires the external mfa binary."""
    if not mfa_available():
        raise RuntimeError(
            "the `mfa` binary is not installed in this environment; alignment "
            "TextGrids must be produced offline (or use the binarizer's "
            "uniform fallback alignment for smoke runs)"
        )
    proc = cfg["processed_data_dir"]
    in_dir = prepare_mfa_inputs(cfg)
    lex = os.path.join(proc, "mfa_dict.txt")
    build_mfa_lexicon(cfg, lex)
    out_dir = os.path.join(proc, "mfa_outputs")
    model_fn = os.path.join(proc, "mfa_model.zip")
    subprocess.check_call(["mfa", "train", in_dir, lex, model_fn, out_dir, "--clean"])
    # flatten group subdirs: the binarizer looks up mfa_outputs/<item>.TextGrid
    for root, _, files in os.walk(out_dir):
        for fn in files:
            if fn.endswith(".TextGrid") and root != out_dir:
                shutil.move(os.path.join(root, fn), os.path.join(out_dir, fn))
    return out_dir
