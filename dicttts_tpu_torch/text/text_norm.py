"""Chinese non-standard-word (NSW) text normalization.

Port of ``dicttts_tpu/text/text_norm.py`` (pure Python, copied): the
upstream Dict-TTS normalizer's rule cascade (``NSWNormalizer.normalize``)
verbalizes, in its order, dates (2- and 4-digit years read digit-wise),
money (块/角/毛/分 and magnitude-suffixed 元/万/亿...), mobile and fixed
phone numbers, fractions, percentages, quantifier-attached cardinals,
decimals, long digit codes (digit by digit), remaining numbers, and the
letters-2-letters restore (O2O/B2C).

Number reading keeps the upstream 两 rule: 二 reads 两 before 百/千/万/亿
unless 十 precedes it. ``chn2num`` parses Chinese numerals back to integers.

``normalize(strict_reference=True)`` gives the upstream readings exactly;
the default mode also verbalizes clock times and ranges and reads 4-6-digit
quantities as cardinals. ``digits2chn`` offers 幺 for 1 (default off).
"""

from __future__ import annotations

import re
import string

DIGITS = "零一二三四五六七八九"
UNITS_SMALL = ["", "十", "百", "千"]
UNITS_BIG = ["", "万", "亿", "兆"]  # 兆 = 10^12, reference numbering system

CHINESE_PUNCS = "！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘'‛“”„‟…‧﹏"

# quantifiers that attach a cardinal reading to the preceding number
# (reference COM_QUANTIFIERS, text_norm.py:41-47 — data list)
COM_QUANTIFIERS = (
    "(匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|"
    "砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|"
    "针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|"
    "毫|厘|分|寸|尺|丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|"
    "盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|旬|"
    "纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|颗|块|元)"
)
CURRENCY_UNITS = "((亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|)元|(亿|千万|百万|万|千|百|)块|角|毛|分)"


def num2chn(num: int, alt_two: bool = True) -> str:
    """Integer -> Chinese reading (0 <= num < 1e16); 两-selection when
    alt_two (reference num2chn alt_two semantics)."""
    if num == 0:
        return DIGITS[0]
    parts = []
    group_idx = 0
    while num > 0:
        group = num % 10000
        if group:
            s = _group2chn(group)
            # 零 between groups when the lower group misses its 千 digit
            # (10518 -> 一万零五百一十八)
            if group < 1000 and num >= 10000:
                s = DIGITS[0] + s
            parts.append(s + UNITS_BIG[group_idx])
        elif parts and not parts[-1].startswith(DIGITS[0]):
            parts.append(DIGITS[0])
        num //= 10000
        group_idx += 1
    out = "".join(reversed(parts))
    out = re.sub(f"{DIGITS[0]}+", DIGITS[0], out).rstrip(DIGITS[0]) or DIGITS[0]
    # idiomatic 一十X -> 十X at the very front
    if out.startswith("一十"):
        out = out[1:]
    if alt_two:
        # 二 -> 两 before 百/千/万/亿 unless right after 十/零 (reference
        # alt_two: only when the previous symbol is absent or a big unit)
        out = re.sub(r"(?<![十零])二(?=[百千万亿兆])", "两", out)
    return out


def _group2chn(group: int) -> str:
    s = ""
    zero_pending = False
    for pos in range(3, -1, -1):
        d = (group // 10**pos) % 10
        if d == 0:
            if s:
                zero_pending = True
            continue
        if zero_pending:
            s += DIGITS[0]
            zero_pending = False
        s += DIGITS[d] + UNITS_SMALL[pos]
    return s


def chn2num(text: str) -> int:
    """Chinese numerals -> integer (reference chn2num capability,
    text_norm.py:233-317). Handles 两, mixed units, and digit strings."""
    table = {c: i for i, c in enumerate(DIGITS)}
    table["两"] = 2
    small = {"十": 10, "百": 100, "千": 1000}
    big = {"万": 10**4, "亿": 10**8, "兆": 10**12}
    if text and all(c in table for c in text):  # digit-by-digit string
        return int("".join(str(table[c]) for c in text))
    total, section, current = 0, 0, 0
    for ch in text:
        if ch in table:
            current = table[ch]
        elif ch in small:
            section += (current or 1) * small[ch]
            current = 0
        elif ch in big:
            b = big[ch]
            if total and total < b:
                # ascending compound (十二万亿): the whole prefix scales
                total = (total + section + current) * b
            else:
                # descending sequence (一亿二十万): only this section scales
                total += (section + current) * b
            section, current = 0, 0
    return total + section + current


def digits2chn(s: str, use_yao: bool = False) -> str:
    """Digit-by-digit reading (phone numbers, codes). The reference reads
    1 as 一 (num2chn alt_one=False); use_yao=True gives the common TTS 幺."""
    one = "幺" if use_yao else "一"
    table = {"0": "零", "1": one, "2": "二", "3": "三", "4": "四",
             "5": "五", "6": "六", "7": "七", "8": "八", "9": "九"}
    return "".join(table.get(c, c) for c in s)


def number2chn(s: str) -> str:
    """Decimal string -> Chinese reading."""
    neg = s.startswith("-")
    s = s.lstrip("+-")
    if "." in s:
        int_part, frac = s.split(".", 1)
        out = num2chn(int(int_part or "0")) + "点" + "".join(DIGITS[int(c)] for c in frac if c.isdigit())
    else:
        out = num2chn(int(s))
    return ("负" if neg else "") + out


# reference numbering units by power of ten, descending (create_system 'mid'
# + the extended units; utils/text_norm.py:120-150)
_REF_UNIT_POWERS = [("兆", 12), ("亿", 8), ("万", 4), ("千", 3), ("百", 2), ("十", 1)]


def _ref_get_value(s: str, use_zeros: bool = True) -> str:
    """The reference's recursive integer reader (get_value, :322-343):
    notable leading-zero semantics — '00' -> '', '05' -> 零五."""
    stripped = s.lstrip("0")
    if not stripped:
        return ""
    if len(stripped) == 1:
        d = DIGITS[int(stripped)]
        return (DIGITS[0] + d) if (use_zeros and len(s) != len(stripped)) else d
    unit, power = next((u, p) for u, p in _REF_UNIT_POWERS if p < len(stripped))
    return _ref_get_value(s[:-power]) + unit + _ref_get_value(stripped[-power:])


def ref_cardinal(s: str) -> str:
    """Reference-exact cardinal reading of a (possibly decimal) numeral
    string, incl. alt_two 两-selection, 点-prefix for bare fractions, and
    the 10-19 一十 strip (num2chn, :317-416)."""
    if "." in s:
        i, d = s.split(".", 1)
        int_part = _ref_get_value(i) if len(i) > 1 else (DIGITS[int(i)] if i else "")
        out = int_part + "点" + "".join(DIGITS[int(c)] for c in d if c.isdigit())
    else:
        out = _ref_get_value(s) if len(s) > 1 else DIGITS[int(s)]
    out = re.sub(r"(?<![十零])二(?=[百千万亿兆])", "两", out)
    if out.startswith("点"):
        out = DIGITS[0] + out
    if out.startswith("一十"):
        out = out[1:]
    return out


class NSWNormalizer:
    """Rule cascade in the reference's order; call `.normalize()`.

    ``strict_reference=True`` reproduces the reference's EXACT readings for
    eval-parity runs: no time verbalization (':' is
    punctuation there), no ¥ or range rules (absent there), and 4-32-digit
    codes read digit-by-digit after decimals (reference Digit rewriter,
    utils/text_norm.py:694-700) instead of our 7+-digit threshold. The
    default mode keeps the TTS-friendlier readings (times, ranges, ¥,
    4-6-digit quantities as cardinals)."""

    def __init__(self, text: str):
        self.text = text

    def normalize(self, remove_punc: bool = False, strict_reference: bool = False) -> str:
        t = self.text
        # dates: 4-digit (19xx/20xx) or 2-digit ([089]x) years digit-wise
        t = re.sub(
            r"((?:19|20)\d{2}|[089]\d)年",
            lambda m: digits2chn(m.group(1)) + "年",
            t,
        )
        t = re.sub(r"(\d{1,2})月", lambda m: num2chn(int(m.group(1))) + "月", t)
        t = re.sub(r"(\d{1,2})([日号])", lambda m: num2chn(int(m.group(1))) + m.group(2), t)
        # times (not in the reference cascade — ':' is punctuation there)
        if not strict_reference:
            t = re.sub(
                r"(\d{1,2}):(\d{2})(?::(\d{2}))?",
                lambda m: num2chn(int(m.group(1))) + "点"
                + (num2chn(int(m.group(2))) + "分" if m.group(2) != "00" else "")
                + (num2chn(int(m.group(3))) + "秒" if m.group(3) else ""),
                t,
            )
        # money: 12块5 / 34.5元 / 20.1万元 / 40多块钱 / ¥5 (reference :630-636)
        if not strict_reference:  # reference has no ¥ rule
            t = re.sub(r"[¥￥](\d+(?:\.\d+)?)", lambda m: number2chn(m.group(1)) + "元", t)
        t = re.sub(
            r"(\d+(?:\.\d+)?)([多余几]?)" + CURRENCY_UNITS + r"(\d)?",
            lambda m: number2chn(m.group(1)) + m.group(2) + m.group(3)
            + (num2chn(int(m.group(7))) if m.group(7) else ""),
            t,
        )
        # phones: mobile (+86 1xx...) and fixed (area-code dash); digit
        # boundaries keep them from firing inside longer codes (the
        # reference anchors with \D, :644-657)
        t = re.sub(
            r"(?<!\d)(?:\+?86 ?)?(1[3-9]\d{9})(?!\d)",
            lambda m: digits2chn(m.group(1)),
            t,
        )
        t = re.sub(
            r"(?<!\d)(0(?:10|2\d|[3-9]\d{2}))-?([1-9]\d{6,7})(?!\d)",
            lambda m: digits2chn(m.group(1)) + digits2chn(m.group(2)),
            t,
        )
        # fractions and percentages
        t = re.sub(r"(\d+)/(\d+)", lambda m: num2chn(int(m.group(2))) + "分之" + num2chn(int(m.group(1))), t)
        t = t.replace("％", "%")
        t = re.sub(r"(\d+(?:\.\d+)?)%", lambda m: "百分之" + number2chn(m.group(1)), t)
        # ranges 3-5 -> 三到五 (not in the reference cascade)
        if not strict_reference:
            t = re.sub(r"(\d+)[-~](\d+)", lambda m: num2chn(int(m.group(1))) + "到" + num2chn(int(m.group(2))), t)
        # cardinal + quantifier (量词) context (reference :675-681)
        t = re.sub(
            r"(\d+(?:\.\d+)?)([多余几]?)" + COM_QUANTIFIERS,
            lambda m: number2chn(m.group(1)) + m.group(2) + m.group(3),
            t,
        )
        if strict_reference:
            # reference order: decimals as cardinals (:685-691), THEN 4-32
            # digit codes digit-by-digit (Digit rewriter, :694-700), then
            # remaining numbers with the reference's exact leading-zero
            # semantics ('00' -> '', '05' -> 零五)
            t = re.sub(r"\d+\.\d+", lambda m: ref_cardinal(m.group(0)), t)
            t = re.sub(r"\d{4,32}", lambda m: digits2chn(m.group(0)), t)
            t = re.sub(r"\d+", lambda m: ref_cardinal(m.group(0)), t)
        else:
            # long digit codes: digit-by-digit (reference Digit, 4-32 digits —
            # we keep 7+ so years/quantities fall through to cardinal reading)
            t = re.sub(r"\d{7,}", lambda m: digits2chn(m.group(0)), t)
            # remaining numbers: quantity reading
            t = re.sub(r"\d+(?:\.\d+)?", lambda m: number2chn(m.group(0)), t)
        # O2O/B2C: restore the digit between ASCII letters (reference
        # _particular, :608-616 — the '2' is later read as English)
        t = re.sub(r"([a-zA-Z]+)二([a-zA-Z]+)", r"\g<1>2\g<2>", t)
        if remove_punc:
            old = CHINESE_PUNCS + string.punctuation
            t = t.translate(str.maketrans(old, " " * len(old)))
        return t


def normalize_text(text: str) -> str:
    return NSWNormalizer(text).normalize()
