"""Praat TextGrid parsing and phone alignment to mel frames.

Port of ``dicttts_tpu/text/textgrid.py`` (pure Python, copied): parse the
'phones' tier of an MFA TextGrid, then give each mel frame a 1-based phone
index. Separator tokens in the phone sequence ('|', '#', punctuation) are
not aligned by MFA; they take the silence intervals between aligned phones
(zero frames where there is no silence).
"""

from __future__ import annotations

import re

SEP_TOKENS = {"|", "#", "<BOS>", "<EOS>"}
SIL_TEXTS = {"", "sil", "sp", "spn", "<SIL>", "sile", "silence"}


def parse_textgrid(content: str, tier_name: str = "phones") -> list[tuple[float, float, str]]:
    """Parse a (long-form) TextGrid string; return the named tier's
    intervals as (xmin, xmax, text)."""
    # isolate the tier
    tiers = re.split(r'item\s*\[\d+\]\s*:', content)
    target = None
    for block in tiers[1:]:
        m = re.search(r'name\s*=\s*"([^"]*)"', block)
        if m and m.group(1) == tier_name:
            target = block
            break
    if target is None and len(tiers) > 1:
        target = tiers[1]  # fall back to the first tier
    if target is None:
        raise ValueError(f"tier {tier_name!r} not found")
    intervals = []
    for m in re.finditer(
        r'intervals\s*\[\d+\]\s*:\s*xmin\s*=\s*([\d.eE+-]+)\s*xmax\s*=\s*([\d.eE+-]+)\s*text\s*=\s*"([^"]*)"',
        target,
    ):
        intervals.append((float(m.group(1)), float(m.group(2)), m.group(3).strip()))
    return intervals


def is_sil_phone(ph: str) -> bool:
    return ph in SEP_TOKENS or not re.search(r"[a-zA-Z\d]", ph)


def textgrid_to_mel2ph(
    intervals: list[tuple[float, float, str]],
    ph_list: list[str],
    n_frames: int,
    hop: int = 256,
    sr: int = 22050,
) -> tuple[list[int], list[int]]:
    """Align TextGrid phone intervals to the full phone sequence.

    ph_list may contain separator/punctuation tokens MFA never aligned;
    non-silence intervals consume the next real phone in order, silence
    intervals are credited to the pending separator token (or appended to
    the previous phone when there is none). Returns (mel2ph [n_frames],
    durs [len(ph_list)]).
    """
    durs = [0] * len(ph_list)
    frame_of = lambda t: int(t * sr / hop + 0.5)
    ph_idx = 0

    def next_real(from_idx):
        j = from_idx
        while j < len(ph_list) and is_sil_phone(ph_list[j]):
            j += 1
        return j

    for xmin, xmax, text in intervals:
        f0_, f1_ = frame_of(xmin), frame_of(xmax)
        n = max(f1_ - f0_, 0)
        if text.lower() in SIL_TEXTS:
            # find a separator token between ph_idx-1 and the next real phone
            j = ph_idx
            sep = None
            while j < len(ph_list) and is_sil_phone(ph_list[j]):
                sep = j
                j += 1
            if sep is not None:
                durs[sep] += n
                ph_idx = sep + 1
            elif ph_idx > 0:
                durs[ph_idx - 1] += n
            else:
                # leading silence with no separator: give to first phone
                durs[0] += 0  # frames before the first phone stay unmapped? map to first sep
                j0 = 0
                durs[j0] += n
        else:
            j = next_real(ph_idx)
            if j >= len(ph_list):
                j = len(ph_list) - 1
            # separators skipped without silence get zero duration
            durs[j] += n
            ph_idx = j + 1

    # build mel2ph from durations
    mel2ph = []
    for i, d in enumerate(durs):
        mel2ph.extend([i + 1] * d)
    if len(mel2ph) < n_frames:
        pad_val = mel2ph[-1] if mel2ph else 1
        mel2ph.extend([pad_val] * (n_frames - len(mel2ph)))
    mel2ph = mel2ph[:n_frames]
    # recompute durs after truncation so sum(durs) == n_frames
    durs = [0] * len(ph_list)
    for v in mel2ph:
        durs[v - 1] += 1
    return mel2ph, durs
