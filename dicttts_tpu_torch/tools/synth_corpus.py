"""Synthetic corpus at the production dictionary's geometry.

Counterpart of ``scripts/synth_corpus.py``: an ~8000-entry word vocabulary
whose every entry carries 1-3 tone-marked pronunciations with gloss
strings, and sine-wave utterances long enough to fill the recipe's
60-sentence x 512-frame batches, pre-aligned and binarized by the port's
``PreAlign`` / ``ZhBinarizer`` (the mel and f0 on ``device``: the card by
default, ``cpu`` for tests). The characters are CJK codepoints from U+4E00
and the pronunciations synthetic (initial x final x tone) syllables; the
g2p resolves them from the same generated dictionary.

    python -m dicttts_tpu_torch.tools.synth_corpus --root .prod_corpus \\
        [--n_words 7997] [--n_items 360] [--seed 0] [--device cuda]

Pre-aligning segments the texts with jieba, and the binarizer's sandhi
needs it too: without jieba the build raises an ImportError naming it.
"""

from __future__ import annotations

import json
import os

import numpy as np

# tone-mark application (inverse of text/pinyin.py TONE_MARKS)
_MARKS = {
    "a": "āáǎà", "o": "ōóǒò", "e": "ēéěè",
    "i": "īíǐì", "u": "ūúǔù", "v": "ǖǘǚǜ",
}

INITIALS = [
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w", "",
]
FINALS = [
    "a", "o", "e", "ai", "ei", "ao", "ou", "an", "en", "ang", "eng", "ong",
    "i", "u", "ia", "ie", "iao", "iu", "ian", "in", "iang", "ing", "iong",
    "ua", "uo", "uai", "ui", "uan", "un", "uang", "er", "v", "ve", "van", "vn",
]


def mark_tone(syllable: str, tone: int) -> str:
    """'ban', 3 -> 'bǎn' (mark a > o/e > last vowel, standard placement)."""
    if not 1 <= tone <= 4:
        raise ValueError(f"tone {tone} is not 1-4")
    for target in ("a", "o", "e"):
        i = syllable.find(target)
        if i >= 0:
            return syllable[:i] + _MARKS[target][tone - 1] + syllable[i + 1 :]
    for i in range(len(syllable) - 1, -1, -1):
        if syllable[i] in _MARKS:
            return syllable[:i] + _MARKS[syllable[i]][tone - 1] + syllable[i + 1 :]
    return syllable


def gen_dictionary(n_words: int, seed: int = 0) -> dict:
    """{char: {tone-marked pinyin: [gloss, ...]}} with 1-3 prons per char."""
    rng = np.random.RandomState(seed)
    chars = [chr(0x4E00 + i) for i in range(n_words)]
    syllables = [i + f for i in INITIALS for f in FINALS]
    d = {}
    for c in chars:
        n_pron = int(rng.choice([1, 2, 3], p=[0.7, 0.25, 0.05]))
        prons = {}
        while len(prons) < n_pron:
            syl = syllables[rng.randint(len(syllables))]
            tone = int(rng.randint(1, 5))
            key = mark_tone(syl, tone)
            if key in prons:
                continue
            n_gloss_chars = int(rng.randint(6, 24))
            gloss = "".join(chars[j] for j in rng.randint(0, n_words, n_gloss_chars))
            prons[key] = [gloss]
        d[c] = prons
    return d


def build_corpus(
    root: str,
    n_words: int = 7997,
    n_items: int = 360,
    seed: int = 0,
    secs_per_char: float = 0.11,
    min_chars: int = 18,
    max_chars: int = 56,
    sr: int = 22050,
    binarize: bool = True,
    extra_cfg: dict | None = None,
    device="cuda",
) -> str:
    """Generate, pre-align and (optionally) binarize; returns the
    binary_data_dir.

    Every dictionary character appears in the corpus text at least once
    (texts slice a shuffled cycle over the full char list), so the built
    word_set and bank cover the whole n_words vocabulary.
    """
    from dicttts_tpu_torch.text.binarizer import PreAlign, ZhBinarizer
    from dicttts_tpu_torch.vocoders.hifigan import save_wav

    bdir = os.path.join(root, "binary")
    if os.path.exists(os.path.join(bdir, "train.idx")) and os.path.exists(
        os.path.join(bdir, "dict_embed.idx")
    ):
        return bdir
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    rng = np.random.RandomState(seed)
    dictionary = gen_dictionary(n_words, seed)
    dict_path = os.path.join(root, "zh-dict.json")
    with open(dict_path, "w") as f:
        json.dump(dictionary, f, ensure_ascii=False)
    chars = list(dictionary)

    # texts: sequential slices over shuffled cycles of the char list -> full
    # vocab coverage as soon as total chars >= n_words
    lengths = rng.randint(min_chars, max_chars + 1, n_items)
    if int(lengths.sum()) < n_words:
        raise ValueError(f"{n_items} items x ~{(min_chars + max_chars) // 2} chars cannot cover "
                         f"{n_words} words; raise n_items")
    stream: list[str] = []
    while len(stream) < int(lengths.sum()):
        order = rng.permutation(len(chars))
        stream.extend(chars[i] for i in order)
    texts, pos = [], 0
    for n in lengths:
        texts.append("".join(stream[pos : pos + int(n)]))
        pos += int(n)

    class SynthPreAlign(PreAlign):
        def meta_data(self):
            for i, text in enumerate(texts):
                secs = secs_per_char * len(text) + 0.5
                t = np.arange(int(sr * secs)) / sr
                f_hz = 120 + 15 * (i % 12)
                wav = (0.3 * np.sin(2 * np.pi * f_hz * t)).astype(np.float32)
                fn = os.path.join(raw, f"s{i:04d}.wav")
                if not os.path.exists(fn):
                    save_wav(fn, wav, sr)
                yield f"s{i:04d}", fn, text

    cfg = {
        "raw_data_dir": raw,
        "processed_data_dir": os.path.join(root, "processed"),
        "binary_data_dir": bdir,
        "dict_path": dict_path,
        "word_size": n_words + 3,
        "dict_embed_dim": 768,
        "test_num": max(n_items // 20, 4),
        "valid_num": max(n_items // 20, 4),
        "use_dict": True,
        "binarize_batch": 16,
        "audio_sample_rate": sr,
        **(extra_cfg or {}),
    }
    SynthPreAlign(cfg).process()
    if binarize:
        ZhBinarizer(cfg, device=device).process()
    return bdir


def main(argv=None) -> str:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--n_words", type=int, default=7997)
    p.add_argument("--n_items", type=int, default=360)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    out = build_corpus(args.root, args.n_words, args.n_items, args.seed, device=args.device)
    print(out)
    return out


if __name__ == "__main__":
    main()
