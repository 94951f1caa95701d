"""Pinyin utilities and dictionary-based Mandarin g2p.

Port of ``dicttts_tpu/text/pinyin.py`` (pure Python, copied). The upstream
zh text processor, dict-bank builder and sandhi engine use pypinyin's
INITIALS/FINALS_TONE3 with strict=False. pypinyin is not a dependency, so
g2p resolves each character's candidate pronunciations from the online
Chinese dictionary (``zh-dict.json``, the same asset the S2PA module
attends over) and splits tone-marked syllables into (initial, final+tone3).

The DEFAULT split is non-strict (the PER label set
scripts/pron_label/label_set0.csv is in this format): y/w count as
initials ("wai4" -> w + ai4), no iou/uei/uen restoration, no u->v after
j/q/x. Pass strict=True for the phonologically strict variant.

Heteronym choice defaults to the dictionary's first reading: at run time
Dict-TTS resolves heteronyms through S2PA attention; the rule engine in
text/sandhi.py supplies the hard overrides. Word segmentation
(``ZhG2P.segment``) needs jieba and raises ``ImportError`` without it.
"""
from __future__ import annotations

import json
import re
from functools import lru_cache

from dicttts_tpu_torch.text.text_norm import NSWNormalizer

TONE_MARKS = {
    "ā": ("a", 1), "á": ("a", 2), "ǎ": ("a", 3), "à": ("a", 4),
    "ē": ("e", 1), "é": ("e", 2), "ě": ("e", 3), "è": ("e", 4),
    "ī": ("i", 1), "í": ("i", 2), "ǐ": ("i", 3), "ì": ("i", 4),
    "ō": ("o", 1), "ó": ("o", 2), "ǒ": ("o", 3), "ò": ("o", 4),
    "ū": ("u", 1), "ú": ("u", 2), "ǔ": ("u", 3), "ù": ("u", 4),
    "ǖ": ("v", 1), "ǘ": ("v", 2), "ǚ": ("v", 3), "ǜ": ("v", 4),
    "ü": ("v", 0), "ḿ": ("m", 2), "ń": ("n", 2), "ň": ("n", 3), "ǹ": ("n", 4),
    "ê": ("e", 0), "ế": ("e", 2), "ề": ("e", 4),
}

INITIALS = [
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x", "r", "z", "c", "s",
]

# non-strict mode additionally treats y/w as initials (pypinyin strict=False)
NONSTRICT_INITIALS = INITIALS + ["y", "w"]

PUNCS = "！，。？、；：!,.?;:"


def strip_tone(syllable: str) -> tuple[str, int]:
    """Tone-marked pinyin -> (plain syllable with v for u-umlaut, tone 0-4)."""
    tone = 0
    out = []
    for ch in syllable:
        if ch in TONE_MARKS:
            base, t = TONE_MARKS[ch]
            out.append(base)
            if t:
                tone = t
        else:
            out.append(ch)
    return "".join(out), tone


def split_initial_final_nonstrict(syllable: str) -> tuple[str, str]:
    """Plain (tone-less) syllable -> (initial, final), pypinyin strict=False
    semantics: initial = longest prefix among initials + y/w; final = rest,
    verbatim (umlaut u is already 'v' from strip_tone)."""
    for cand in NONSTRICT_INITIALS:
        if syllable.startswith(cand) and len(syllable) > len(cand):
            return cand, syllable[len(cand):]
    return "", syllable


def split_initial_final(syllable: str) -> tuple[str, str]:
    """Plain (tone-less) syllable -> (initial, strict-mode final)."""
    s = syllable
    initial = ""
    for cand in INITIALS:
        if s.startswith(cand):
            initial, s = cand, s[len(cand):]
            break
    if initial == "" and s:
        # zero-initial y/w restoration (strict finals)
        if s.startswith("yu"):
            s = "v" + s[2:]
        elif s.startswith("yi"):
            s = s[1:]
        elif s.startswith("y"):
            s = "i" + s[1:]
        elif s.startswith("wu"):
            s = s[1:]
        elif s.startswith("w"):
            s = "u" + s[1:]
    else:
        # strict restorations after an initial
        if s == "iu":
            s = "iou"
        elif s == "ui":
            s = "uei"
        elif s == "un" and initial not in ("j", "q", "x", "y"):
            s = "uen"
        if initial in ("j", "q", "x") and s.startswith("u"):
            s = "v" + s[1:]
    return initial, s


def pinyin_to_tone3(syllable: str, strict: bool = False) -> tuple[str, str]:
    """Tone-marked syllable -> (initial, final+tone3 digit or '').

    Default strict=False matches the reference pipeline (pypinyin
    strict=False in zh.py/binarizer_zh.py/sandhi_processor.py) and the PER
    label format; neutral tone carries no digit (neutral_tone_with_five
    False in the text processors)."""
    plain, tone = strip_tone(syllable.strip())
    split = split_initial_final if strict else split_initial_final_nonstrict
    initial, final = split(plain)
    return initial, final + (str(tone) if tone else "")


class ZhDict:
    """The online Chinese dictionary: char -> {pinyin: [glosses]}."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            self.entries: dict[str, dict[str, list[str]]] = json.load(f)

    def prons(self, char: str) -> list[str]:
        return list(self.entries.get(char, {}).keys())

    def glosses(self, char: str, pron: str) -> list[str]:
        return self.entries.get(char, {}).get(pron, [])

    def __contains__(self, char: str) -> bool:
        return char in self.entries

    def __len__(self):
        return len(self.entries)


@lru_cache(maxsize=4)
def load_dict(path: str) -> ZhDict:
    return ZhDict(path)


class ZhG2P:
    """Character-level g2p over the dictionary, with jieba word boundaries.

    process(txt) returns (ph_list, txt) where ph_list interleaves
    [initial, final_tone3] per char with '|' between chars of the same word
    and '#' at jieba word boundaries — the reference's separator scheme
    (upstream txt_processors/zh.py:57-80). ASCII words become 'ENG'.

    pos_merge=True is the zh_dict processor variant
    (txt_processors/zh_dict.py:68-71): word boundaries come from
    jieba.posseg + the sandhi engine's pre-merge passes (不/一/
    reduplication/儿 folded into their neighbors) so they line up with the
    pron_modified indices.
    """

    def __init__(self, dict_path: str, pos_merge: bool = False, strict_nsw: bool = False):
        self.zh_dict = load_dict(dict_path)
        self.pos_merge = pos_merge
        # strict_nsw: reference-exact NSW readings for eval-parity runs
        # (cfg key nsw_strict_reference) — see text_norm.NSWNormalizer
        self.strict_nsw = strict_nsw

    def char_phones(self, char: str) -> list[str]:
        prons = self.zh_dict.prons(char)
        if not prons:
            return [char]  # punctuation / unknown passthrough
        initial, final = pinyin_to_tone3(prons[0])
        return [p for p in (initial, final) if p]

    def preprocess(self, txt: str) -> str:
        txt = NSWNormalizer(txt.strip()).normalize(strict_reference=self.strict_nsw)
        txt = re.sub("[　 ]+", "", txt)
        return txt

    def segment(self, txt: str) -> list[str]:
        from dicttts_tpu_torch.text.sandhi import SandhiProcessor, require_jieba

        if self.pos_merge:
            seg = [[w, p] for w, p in require_jieba("posseg").lcut(txt)]
            return [w for w, _ in SandhiProcessor.pre_merge_for_modify(seg)]
        return list(require_jieba().cut(txt))

    def process(self, txt: str) -> tuple[list[str], str]:
        txt = self.preprocess(txt)
        txt = txt.replace("嗯", "恩")  # reference zh_dict.py:53 alignment fix
        words = self.segment(txt)
        ph_list: list[str] = []
        for w_i, word in enumerate(words):
            if w_i > 0:
                ph_list.append("#")
            if re.fullmatch(r"[a-zA-Z']+", word):
                ph_list.append("ENG")
                continue
            for c_i, char in enumerate(word):
                if c_i > 0:
                    ph_list.append("|")
                ph_list.extend(self.char_phones(char))
        # drop word boundaries adjacent to silence phones (reference :81-87)
        sil = set(PUNCS)
        out: list[str] = []
        for i, p in enumerate(ph_list):
            if p == "#" and (
                (i > 0 and ph_list[i - 1] in sil) or (i + 1 < len(ph_list) and ph_list[i + 1] in sil)
            ):
                continue
            out.append(p)
        return out, txt
