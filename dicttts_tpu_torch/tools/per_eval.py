"""The PER pipeline: a heteronym-rich, sandhi-exercising corpus -> train ->
``--infer`` -> the reference's PER scoring, with slot diagnostics.

Counterpart of ``scripts/per_eval.py``. The real Biaobei corpus and its
MFA alignments are not in the repo, so the published PER (~1.93 %) cannot
be reproduced literally; this builds the closest proxy and records its
provenance in the result:

- characters and pronunciations come from a zh-dict.json (``--dict``; the
  configs' ``data/zh-dict.json`` by default, where the reference's 7030-entry
  dictionary goes);
- each sentence holds 3-5 heteronyms between context characters drawn from
  the gloss text of the intended reading, so the reading can only be
  inferred from semantic context, the task S2PA exists for; the
  first-reading baseline PER is reported beside the model's;
- tone sandhi runs through ``text/sandhi.py``, the binarizer's engine;
  where it forces a reading (不/一/neutral tone) the audio and the gold
  labels follow it;
- every distinct syllable gets its own 3-partial signature (a distinct
  3-subset of a 24-point mel-equidistant frequency grid, bank v2), so the
  mel fully determines the reading;
- the 50 test sentences come from their own RNG stream (seed 12345) and
  are kept in ``--test_set`` (``data/per_test_set.json`` by default), written
  on the first run on a dictionary and held to the generator after; a run
  on another dictionary names its own file and never rewrites that one;
- the corpus is binarized by the port's ``ZhBinarizer`` (mel and f0 on
  ``--device``), trained and inferred by ``python -m dicttts_tpu_torch.run
  --device ...`` in a subprocess (work dir ``checkpoints/per_eval_<tag>`` in
  the repo), and scored by ``eval/per.pron_error_rate_files``; the errors
  are split by slot kind (``slot_diagnostics``), and ``--score_train`` also
  scores 50 held-in train sentences.

    python -m dicttts_tpu_torch.tools.per_eval [--max_updates 100000] [--n_items 6000]
        [--dict data/zh-dict.json] [--root .per_corpus] [--test_set data/per_test_set.json]
        [--out <root>/PER_<tag>.json] [--device cuda] [--score_train] [--fresh]

The config written for the run (``<root>/per.yaml``) keeps the JAX
script's ``steps_per_dispatch: 8``: the port's trainer groups up to 8
same-shape steps, and on the card replays each as a CUDA graph
(``train/graphs.py``). Segmentation and sandhi need
jieba; on a machine without it, ``main(argv, text=FixedText(table))`` takes
both from a table computed ahead of time.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DICT = os.path.join(REPO, "data", "zh-dict.json")
DEFAULT_ROOT = os.path.join(REPO, ".per_corpus")
DEFAULT_TEST_SET = os.path.join(REPO, "data", "per_test_set.json")
BASE_CONFIG = os.path.join(REPO, "dicttts_tpu_torch", "configs", "tts", "dict_tts.yaml")
N_TEST = 50
TEST_SEED = 12345
BANK_VERSION = 2


class FixedText:
    """The pre-align phones and sandhi overrides of known texts, computed
    ahead of time for a machine without jieba: {'g2p': {text: {'ph': phones
    joined by spaces, 'norm': normalized text}}, 'sandhi': {text:
    overrides}} (``scripts/make_sandhi_fixture.py`` writes such a table). A
    text it does not hold raises."""

    def __init__(self, table: dict):
        from dicttts_tpu_torch.text.sandhi import FixedSandhi

        self.table = table
        self.sandhi = FixedSandhi(table["sandhi"])

    def process(self, txt: str) -> tuple[list[str], str]:
        if txt not in self.table["g2p"]:
            raise KeyError(f"no precomputed pre-align phones for {txt!r}")
        entry = self.table["g2p"][txt]
        return entry["ph"].split(" "), entry["norm"]

    def process_sandhi(self, text: str, words=None) -> list[int]:
        return self.sandhi.process_sandhi(text, words)


# -- corpus ------------------------------------------------------------------

def _select_heteronyms(zd, max_heteronyms: int):
    """Heteronym chars whose every reading has gloss text rich enough to
    supply single-pronunciation context characters."""
    single = {c for c in zd.entries if len(zd.prons(c)) == 1}
    het = []
    for c in zd.entries:
        prons = zd.prons(c)
        if len(prons) < 2:
            continue
        ok = True
        ctx = {}
        for p in prons:
            chars = [g for g in "".join(zd.glosses(c, p)) if g in single and g != c]
            seen = []  # de-dup, keep order
            for g in chars:
                if g not in seen:
                    seen.append(g)
            if len(seen) < 4:
                ok = False
                break
            ctx[p] = seen[:24]
        if ok:
            het.append((c, ctx))
        if len(het) >= max_heteronyms:
            break
    return het, single


def _mel_scale(f):
    f = np.asarray(f, np.float64)
    return np.where(f < 1000.0, f / 66.6667,
                    15.0 + 27.0 * np.log(np.maximum(f, 1.0) / 1000.0) / np.log(6.4))


def _mel_inv(m):
    m = np.asarray(m, np.float64)
    return np.where(m < 15.0, m * 66.6667,
                    1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0))


def _syllable_bank(syls: list[str]):
    """Unique 3-partial signature per distinct syllable: the i-th
    3-combination of a 24-frequency mel-equidistant grid (C(24,3)=2024), so
    any two syllables differ by a partial the 80-bin mel resolves."""
    grid = _mel_inv(np.linspace(_mel_scale(220.0), _mel_scale(7600.0), 24))
    combos = list(itertools.combinations(range(24), 3))
    uniq = sorted(set(syls))
    if len(uniq) > len(combos):
        raise ValueError(f"{len(uniq)} syllables > C(24,3)")
    return {s: tuple(float(grid[c]) for c in combos[i]) for i, s in enumerate(uniq)}


def _render(syl_seq: list[str], bank, sr: int, secs_per_char: float) -> np.ndarray:
    segs = []
    n = int(sr * secs_per_char)
    t = np.arange(n) / sr
    env = np.minimum(1.0, np.minimum(np.arange(n), np.arange(n)[::-1]) / (0.012 * sr))
    for s in syl_seq:
        f0, f1, f2 = bank[s]
        w = (0.22 * np.sin(2 * np.pi * f0 * t)
             + 0.14 * np.sin(2 * np.pi * f1 * t)
             + 0.10 * np.sin(2 * np.pi * f2 * t))
        segs.append((w * env).astype(np.float32))
    segs.append(np.zeros(int(0.25 * sr), np.float32))
    return np.concatenate(segs)


def _gen_items(zd, het, rng, n_items: int, prefix: str):
    """Sentences of 3-5 heteronym slots, each between 3-5 context chars
    drawn from the intended reading's gloss support, with 不/一 sandhi
    triggers sprinkled in. Returns [(name, text, reading per char or None)]."""
    triggers = [c for c in ("不", "一") if c in zd.entries]
    items = []
    for i in range(n_items):
        text, choice = [], []
        for _ in range(int(rng.randint(3, 6))):
            c, ctx = het[rng.randint(len(het))]
            prons = zd.prons(c)
            r = int(rng.randint(len(prons)))
            support = ctx[prons[r]]
            k = int(rng.randint(3, 6))
            picks = [support[j] for j in rng.randint(0, len(support), k)]
            m = int(rng.randint(1, k))
            seg = picks[:m] + [c] + picks[m:]
            segc = [None] * m + [r] + [None] * (k - m)
            if triggers and rng.rand() < 0.25:
                j = int(rng.randint(len(seg) + 1))
                seg.insert(j, triggers[rng.randint(len(triggers))])
                segc.insert(j, None)
            text.extend(seg)
            choice.extend(segc)
        items.append((f"{prefix}{i:05d}", "".join(text), choice))
    return items


def _fixed_test_items(zd, het, test_set: str):
    """The 50 test sentences from their own RNG stream (seed 12345), kept in
    ``test_set``: written when it is missing, else held to the generator."""
    items = _gen_items(zd, het, np.random.RandomState(TEST_SEED), N_TEST, "t")
    ser = [{"name": n, "text": t, "choice": c} for n, t, c in items]
    if os.path.exists(test_set):
        with open(test_set, encoding="utf-8") as f:
            on_disk = json.load(f)
        if on_disk != ser:
            raise ValueError(
                f"{test_set} does not match the generator output: the dictionary or the recipe "
                "changed; name another --test_set to accept a new test set (breaks comparisons "
                "with earlier runs)")
    else:
        os.makedirs(os.path.dirname(os.path.abspath(test_set)), exist_ok=True)
        with open(test_set, "w", encoding="utf-8") as f:
            json.dump(ser, f, ensure_ascii=False, indent=0)
    return items


def gold_syllables(zd, sandhi, items):
    """Gold syllables per item (the chosen reading at heteronym slots, the
    first elsewhere, then the sandhi overrides exactly as the binarizer
    applies them) and the context-free baseline (first reading + the
    overrides). Returns (gold, baseline, counts)."""
    gold: dict[str, list[str]] = {}
    baseline: dict[str, list[str]] = {}
    n_sandhi = n_het_slots = n_first_correct = 0
    for name, text, choice in items:
        mods = sandhi.process_sandhi(text)
        syls, base = [], []
        for j, ch in enumerate(text):
            prons = zd.prons(ch)
            r = choice[j] if choice[j] is not None else 0
            b = 0
            if j < len(mods) and mods[j] > 0 and mods[j] <= len(prons):
                r = b = mods[j] - 1
                n_sandhi += 1
            if choice[j] is not None:
                n_het_slots += 1
                n_first_correct += int(r == 0)
            syls.append(prons[r])
            base.append(prons[b])
        gold[name] = syls
        baseline[name] = base
    return gold, baseline, {"sandhi": n_sandhi, "het_slots": n_het_slots,
                            "first_correct": n_first_correct}


def _shown(path: str) -> str:
    """``path`` relative to the repo when it lies inside it."""
    rel = os.path.relpath(os.path.abspath(path), REPO)
    return path if rel.startswith("..") else rel


def build_per_corpus(root: str, n_items: int, dict_path: str, test_set: str = DEFAULT_TEST_SET,
                     seed: int = 0, max_heteronyms: int = 160, sr: int = 22050,
                     secs_per_char: float = 0.11, device="cuda", text: FixedText | None = None):
    """Generate, pre-align and binarize (on ``device``) the corpus under
    ``root``; ``text``: phones and sandhi computed ahead of time (else jieba
    runs). Returns (binary_data_dir, gold, baseline, stats, binarizer or
    None when the binaries already existed)."""
    from dicttts_tpu_torch.text.binarizer import PreAlign, ZhBinarizer
    from dicttts_tpu_torch.text.pinyin import load_dict
    from dicttts_tpu_torch.text.sandhi import SandhiProcessor
    from dicttts_tpu_torch.vocoders.hifigan import save_wav

    zd = load_dict(dict_path)
    sandhi = text if text is not None else SandhiProcessor(zd)
    het, _ = _select_heteronyms(zd, max_heteronyms)
    # test items first (the binarizer takes test = rows[:test_num]), then the
    # train/valid stream, whose RNG is independent of the test stream
    items = _fixed_test_items(zd, het, test_set)
    items += _gen_items(zd, het, np.random.RandomState(seed), n_items, "h")
    gold, baseline, counts = gold_syllables(zd, sandhi, items)
    bank = _syllable_bank([s for syls in gold.values() for s in syls])

    raw = os.path.join(root, f"raw_v{BANK_VERSION}")
    os.makedirs(raw, exist_ok=True)

    class PerPreAlign(PreAlign):
        def meta_data(self):
            for name, txt, _ in items:
                fn = os.path.join(raw, f"{name}.wav")
                if not os.path.exists(fn):
                    save_wav(fn, _render(gold[name], bank, sr, secs_per_char), sr)
                yield name, fn, txt

    bdir = os.path.join(root, f"binary_n{n_items}_v{BANK_VERSION}")
    cfg = {
        "raw_data_dir": raw,
        "processed_data_dir": os.path.join(root, f"processed_n{n_items}_v{BANK_VERSION}"),
        "binary_data_dir": bdir,
        "dict_path": dict_path,
        "word_size": 12000,
        "dict_embed_dim": 768,
        "test_num": N_TEST,
        "valid_num": 20,
        "use_dict": True,
        "binarize_batch": 16,
        "audio_sample_rate": sr,
        "txt_processor": "zh_dict",
    }
    if text is not None:
        cfg["sandhi_overrides"] = os.path.join(root, "sandhi_overrides.json")
        with open(cfg["sandhi_overrides"], "w", encoding="utf-8") as f:
            json.dump(text.table["sandhi"], f, ensure_ascii=False)
    binarizer = None
    if not (os.path.exists(os.path.join(bdir, "train.idx"))
            and os.path.exists(os.path.join(bdir, "dict_embed.idx"))):
        binarizer = ZhBinarizer(cfg, device=device)  # first: a missing card raises before any work
        pre = PerPreAlign(cfg)
        if text is not None:
            pre.g2p = text
        pre.process()
        binarizer.process()

    stats = {
        "n_items": n_items,
        "n_test_items": N_TEST,
        "test_set": _shown(test_set),
        "n_heteronym_chars": len(het),
        "heteronym_slots": counts["het_slots"],
        "sandhi_overrides_applied": counts["sandhi"],
        "first_pron_heteronym_acc": round(counts["first_correct"] / max(counts["het_slots"], 1), 4),
        "distinct_syllables": len(bank),
    }
    return bdir, gold, baseline, stats, binarizer


def write_labels(bdir: str, split: str, gold: dict, out_csv: str) -> int:
    """Gold labels for a split, in split order, in the reference
    label_set0.csv layout (scored positionally against meta.csv rows)."""
    from dicttts_tpu_torch.text.pinyin import pinyin_to_tone3
    from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset

    rows = []
    with IndexedDataset(os.path.join(bdir, split)) as ds:
        for i in range(len(ds)):
            item = ds[i]
            name = item["item_name"]
            phs = []
            for syl in gold[name]:
                ini, fin = pinyin_to_tone3(syl)
                phs.append(f"{ini} {fin}" if ini else fin)
            ph = "<BOS> " + " | ".join(phs) + " <EOS>"
            rows.append(f"{i},{name},SPK1,{item['txt']},{ph},{name}.wav,{{}}")
    with open(out_csv, "w", encoding="utf-8") as f:
        f.write(",item_name,spk,txt,ph,wav_fn,others\n")
        f.write("\n".join(rows) + "\n")
    return len(rows)


def make_train_probe(bdir: str, n: int = 50) -> str:
    """Copy the first n train items into a 'trainprobe' split, so that the
    CLI's infer path can score held-in sentences (optimization vs
    generalization error)."""
    from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset, IndexedDatasetBuilder

    if not os.path.exists(os.path.join(bdir, "trainprobe.idx")):
        with IndexedDataset(os.path.join(bdir, "train")) as ds:
            n = min(n, len(ds))
            b = IndexedDatasetBuilder(os.path.join(bdir, "trainprobe"))
            lengths = []
            for i in range(n):
                item = ds[i]
                b.add_item(item)
                lengths.append(item["len"])
            b.finalize()
        np.save(os.path.join(bdir, "trainprobe_lengths.npy"), np.asarray(lengths))
        src = os.path.join(bdir, "train_f0s_mean_std.npy")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(bdir, "trainprobe_f0s_mean_std.npy"))
    return "trainprobe"


# -- train + infer + score -----------------------------------------------------

def write_config(root: str, bdir: str, dict_path: str, max_updates: int, extra: str = "") -> str:
    cfg = f"""\
base_config:
  - {BASE_CONFIG}

binary_data_dir: {bdir}
dict_path: {dict_path}
lm_model: ''
use_pitch_embed: false

max_sentences: 48
max_tokens: 26000
max_frames: 512
mel_buckets: [512]
txt_buckets: [40]
gloss_buckets: [128]
pinyin_buckets: [16]
sentence_buckets: [48]
frames_multiple: 4

max_updates: {max_updates}
val_check_interval: 2000
valid_infer_interval: 1000000000
num_sanity_val_steps: 2
eval_max_batches: 4
tb_log_interval: 200
steps_per_dispatch: 8
amp: true
use_device_dict_bank: true
use_device_frame_cache: true
disc_start_steps: {max_updates // 4}
{extra}
"""
    fn = os.path.join(root, "per.yaml")
    with open(fn, "w") as f:
        f.write(cfg)
    return fn


def slot_diagnostics(labels_csv: str, meta_csv: str, dict_path: str,
                     out_json: str | None = None, sandhi=None) -> dict:
    """Where the errors live: single-pronunciation syllables (mechanics:
    should be ~0) vs heteronym slots (the disambiguation task), the
    sandhi-forced slots (the rule override decides those) apart from the
    free ones, the collapse-to-first-reading share, and every slot dumped to
    ``out_json``. ``sandhi``: the engine (jieba's by default)."""
    from dicttts_tpu_torch.eval.per import load_label_set, load_meta_predictions
    from dicttts_tpu_torch.text.pinyin import load_dict, pinyin_to_tone3
    from dicttts_tpu_torch.text.sandhi import SandhiProcessor

    labels = load_label_set(labels_csv)
    preds = load_meta_predictions(meta_csv)
    zd = load_dict(dict_path)
    sandhi = sandhi if sandhi is not None else SandhiProcessor(zd)
    tone3 = {}  # tone-marked pinyin -> merged tone3 syllable ("kǎ" -> "ka3")

    def t3(syl: str) -> str:
        if syl not in tone3:
            ini, fin = pinyin_to_tone3(syl)
            tone3[syl] = ini + fin
        return tone3[syl]

    with open(labels_csv, encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    single_tot = single_err = het_tot = het_err = pred_first = 0
    forced_tot = forced_err = free_tot = free_err = 0
    slots, skipped = [], 0
    for row, lab, pred in zip(rows, labels, preds):
        txt = row["txt"]
        if len(lab) != len(pred) or len(lab) != len(txt):
            skipped += 1
            continue  # alignment slips are counted by the headline PER only
        mods = sandhi.process_sandhi(txt)
        for j, (ch, g, p) in enumerate(zip(txt, lab, pred)):
            prons = zd.prons(ch) if ch in zd.entries else []
            if len(prons) >= 2:
                het_tot += 1
                het_err += int(g != p)
                pred_first += int(p == t3(prons[0]))
                forced = j < len(mods) and 0 < mods[j] <= len(prons)
                if forced:
                    forced_tot += 1
                    forced_err += int(g != p)
                else:
                    free_tot += 1
                    free_err += int(g != p)
                slots.append({
                    "item": row["item_name"], "pos": j, "char": ch,
                    "gold": g, "pred": p, "forced": bool(forced),
                    "gold_is_first": g == t3(prons[0]),
                    "n_readings": len(prons),
                })
            else:
                single_tot += 1
                single_err += int(g != p)
    per_char: dict[str, list[int]] = {}
    for s in slots:
        a = per_char.setdefault(s["char"], [0, 0])
        a[0] += int(s["gold"] != s["pred"])
        a[1] += 1
    worst = sorted(per_char.items(), key=lambda kv: -kv[1][0])
    if out_json:
        with open(out_json, "w", encoding="utf-8") as f:
            json.dump({"slots": slots,
                       "per_char_err": {c: {"err": e, "tot": t} for c, (e, t) in worst}},
                      f, ensure_ascii=False, indent=0)
    return {
        "single_pron_syllables": single_tot,
        "single_pron_errors": single_err,
        "heteronym_slots": het_tot,
        "heteronym_errors": het_err,
        "heteronym_acc_pct": round(100 * (1 - het_err / max(het_tot, 1)), 2),
        "free_slots": free_tot,
        "free_errors": free_err,
        "free_acc_pct": round(100 * (1 - free_err / max(free_tot, 1)), 2),
        "sandhi_forced_slots": forced_tot,
        "sandhi_forced_errors": forced_err,
        "model_predicts_first_reading_pct": round(100 * pred_first / max(het_tot, 1), 2),
        "rows_skipped_len_mismatch": skipped,
        "worst_chars": [
            {"char": c, "err": e, "tot": t} for c, (e, t) in worst[:10] if e > 0
        ],
    }


def run_argv(cfg_fn: str, exp_name: str, infer: bool = False, hparams: str = "",
             device: str = "cuda") -> list[str]:
    """The arguments of ``dicttts_tpu_torch.run`` for one train or infer run."""
    argv = ["--config", cfg_fn, "--exp_name", exp_name, "--device", device]
    if infer:
        argv.append("--infer")
    if hparams:
        argv += ["--hparams", hparams]
    return argv


def run_cli(cfg_fn: str, exp_name: str, log_fn: str, infer: bool = False, hparams: str = "",
            device: str = "cuda") -> None:
    """``python -m dicttts_tpu_torch.run`` in the repo (work dir
    ``checkpoints/<exp_name>``), its output to ``log_fn``; raises on failure."""
    cmd = [sys.executable, "-m", "dicttts_tpu_torch.run",
           *run_argv(cfg_fn, exp_name, infer, hparams, device)]
    with open(log_fn, "w") as logf:
        rc = subprocess.call(cmd, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT)
    if rc != 0:
        raise RuntimeError(f"{' '.join(cmd[3:])} rc={rc}; see {log_fn}")


def main(argv=None, text: FixedText | None = None) -> dict:
    """Run the command line ``argv``; returns the result written to
    ``--out``. ``text``: phones and sandhi computed ahead of time, for a
    machine without jieba."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--max_updates", type=int, default=100000)
    ap.add_argument("--n_items", type=int, default=6000,
                    help="train + valid sentence count (the test set is the fixed 50)")
    ap.add_argument("--dict", dest="dict_path", default=DEFAULT_DICT,
                    help="zh-dict.json (the reference's data asset; not in the repo)")
    ap.add_argument("--root", default=DEFAULT_ROOT, help="corpus, labels, logs and per.yaml")
    ap.add_argument("--test_set", default=DEFAULT_TEST_SET,
                    help="the fixed test sentences: written if missing, else held to the generator")
    ap.add_argument("--out", default="", help="result JSON (default <root>/PER_<tag>.json)")
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--tag", default="r05", help="experiment tag: checkpoints/per_eval_<tag>")
    ap.add_argument("--hparams", default="", help="extra config overrides passed to the train/infer "
                    "CLI (comma list)")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse an existing trained exp; just infer + score")
    ap.add_argument("--skip_infer", action="store_true",
                    help="reuse an existing meta.csv; just score")
    ap.add_argument("--score_train", action="store_true",
                    help="also infer and score 50 held-in train sentences (optimization vs "
                         "generalization split)")
    args = ap.parse_args(argv)
    dict_path, root, test_set = (os.path.abspath(p) for p in (args.dict_path, args.root, args.test_set))
    out_fn = os.path.abspath(args.out or os.path.join(root, f"PER_{args.tag}.json"))
    if not os.path.exists(dict_path):
        raise FileNotFoundError(f"zh-dict not found at {dict_path}; pass --dict (the dictionary is "
                                "the reference's data asset, not in the repo)")
    os.makedirs(root, exist_ok=True)
    exp_name = f"per_eval_{args.tag}"
    sandhi = text  # None: slot_diagnostics runs jieba's engine

    t0 = time.time()
    print("| per: building the heteronym corpus...", flush=True)
    bdir, gold, baseline, stats, _ = build_per_corpus(root, args.n_items, dict_path, test_set,
                                                      device=args.device, text=text)
    labels_csv = os.path.join(root, "labels.csv")
    n_test = write_labels(bdir, "test", gold, labels_csv)

    # the context-free baseline over the same test rows: the first reading
    # everywhere plus the rule-based sandhi overrides
    from dicttts_tpu_torch.eval.per import pron_error_rate_files, wer
    from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset

    with IndexedDataset(os.path.join(bdir, "test")) as test_ds:
        test_names = [test_ds[i]["item_name"] for i in range(len(test_ds))]
    baseline_per = wer([gold[n] for n in test_names], [baseline[n] for n in test_names])
    print(f"| per: corpus ready ({stats}); {n_test} test items; "
          f"first-pron baseline PER {100 * baseline_per:.2f}%", flush=True)
    cfg_fn = write_config(root, bdir, dict_path, args.max_updates)

    work_dir = os.path.join(REPO, "checkpoints", exp_name)
    if args.fresh:
        shutil.rmtree(work_dir, ignore_errors=True)

    train_secs = infer_secs = None
    if not args.skip_train:
        print("| per: training via the CLI...", flush=True)
        t1 = time.time()
        run_cli(cfg_fn, exp_name, os.path.join(root, "train.log"), hparams=args.hparams,
                device=args.device)
        train_secs = time.time() - t1
    if not args.skip_infer:
        print("| per: inference via the CLI...", flush=True)
        t2 = time.time()
        run_cli(cfg_fn, exp_name, os.path.join(root, "infer.log"), infer=True,
                hparams=args.hparams, device=args.device)
        infer_secs = time.time() - t2

    gen_dir = os.path.join(work_dir, "generated")
    meta_csv = os.path.join(root, "meta_test.csv")
    shutil.copy(os.path.join(gen_dir, "meta.csv"), meta_csv)
    per = pron_error_rate_files(meta_csv, labels_csv)
    breakdown = slot_diagnostics(labels_csv, meta_csv, dict_path,
                                 os.path.join(root, "slot_diag.json"), sandhi)

    train_probe = None
    if args.score_train:
        try:
            print("| per: scoring 50 held-in train sentences...", flush=True)
            probe = make_train_probe(bdir, 50)
            probe_labels = os.path.join(root, "labels_trainprobe.csv")
            write_labels(bdir, probe, gold, probe_labels)
            run_cli(cfg_fn, exp_name, os.path.join(root, "infer_train.log"), infer=True,
                    hparams=(args.hparams + "," if args.hparams else "") + f"test_set_name={probe}",
                    device=args.device)
            probe_meta = os.path.join(root, "meta_trainprobe.csv")
            shutil.copy(os.path.join(gen_dir, "meta.csv"), probe_meta)
            train_probe = {
                "per_pct": round(100 * pron_error_rate_files(probe_meta, probe_labels), 3),
                **{k: v for k, v in slot_diagnostics(
                    probe_labels, probe_meta, dict_path,
                    os.path.join(root, "slot_diag_train.json"), sandhi).items()
                   if k != "worst_chars"},
            }
        except Exception as e:  # a diagnostic extra: the headline result is still written
            traceback.print_exc()
            train_probe = {"error": repr(e)}

    with open(dict_path, encoding="utf-8") as f:
        n_entries = len(json.load(f))
    result = {
        "per_pct": round(100 * per, 3),
        "reference_anchor_per_pct": 1.93,
        "n_test_items": n_test,
        "max_updates": args.max_updates,
        "hparams": args.hparams or "(recipe defaults)",
        "bank_version": BANK_VERSION,
        "train_secs": round(train_secs, 1) if train_secs else None,
        "infer_secs": round(infer_secs, 1) if infer_secs else None,
        "breakdown": breakdown,
        "train_probe": train_probe,
        "provenance": {
            "corpus": f"synthetic sentences over the zh-dict ({_shown(dict_path)}, {n_entries} entries)",
            "task": "heteronym disambiguation from gloss-derived semantic "
                    "context; readings drawn uniformly per slot",
            "audio": "pronunciation-faithful 3-partial signatures (bank v2: "
                     "each syllable a distinct 3-subset of a 24-point "
                     "mel-equidistant grid, so any two syllables differ by "
                     ">=1 mel-resolvable partial)",
            "gloss_features": "deterministic crc32-seeded gaussian stand-in "
                              "(lm_model is empty: no RoFormer weights)",
            "sandhi": "text/sandhi.py overrides applied to audio AND labels",
            "test_set": f"FIXED 50 sentences at {_shown(test_set)} (own RNG stream, seed 12345)",
            "device": args.device,
            "not_claimed": "Biaobei acoustics / MOS / the literal 1.93% anchor: "
                           "the corpus and its alignments are not in the repo; "
                           "this measures the S2PA pronunciation machinery "
                           "end-to-end on held-out sentences",
            **stats,
            "first_pron_baseline_per_pct": round(100 * baseline_per, 3),
        },
        "total_secs": round(time.time() - t0, 1),
    }
    with open(out_fn, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
