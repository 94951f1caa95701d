"""Mandarin tone-sandhi rule engine -> hard pronunciation overrides.

Port of ``dicttts_tpu/text/sandhi.py`` (pure Python, copied; the word lists
are data). ``process_sandhi(text)`` gives, per input character, a 1-based
index into that character's pronunciation list in the online dictionary
(0 = no override). Those indices feed S2PA's straight-through rule override
(``models/dict_encoder.apply_pron_rule``). The rules follow the upstream
Dict-TTS SandhiProcessor (sandhi_processor.py):

- jieba.posseg segmentation with the upstream pre-merge passes (:437-443):
  不+next word, 一 between verb reduplication and 一+next, reduplicated
  words, and 儿 merged into the preceding word;
- POS-conditioned neutral-tone rules (:109-210): reduplication under
  n/v/a, sentence-final particles, 的/地/得 with their lexical exception
  lists, 了/着 under ul/uz/ug, noun suffixes 子/们 under r/n, 儿 in the
  must-erhua list, and the obligatory neutral-tone word list applied to
  jieba.cut_for_search subwords (:203-210);
- 不 sandhi (:213-227): neutral in V-不-V, bu2 before tone 4;
- 一 sandhi (:229-263): unchanged in numerals, neutral between verb
  reduplication, yi1 as ordinal (第一), yi2 before tone 4, yi4 otherwise;
- erhua (:400-424): 儿-merge is active; the final+"r" rewrite stays off,
  as upstream ships it, with the must/not_erhua gating kept.

Divergences from upstream, as in the JAX package: a missing reading gives
0 (no override) where upstream would raise, and 'eng' segments advance the
character cursor, which upstream forgets to do (:458-460).

Segmentation needs jieba. Without it ``process_sandhi`` raises an
``ImportError`` that names jieba: the overrides are never skipped silently.
A caller on a machine without jieba passes precomputed overrides instead
(``FixedSandhi``).
"""

from __future__ import annotations

import importlib

from dicttts_tpu_torch.text.pinyin import ZhDict, pinyin_to_tone3


def require_jieba(submodule: str | None = None):
    """``jieba`` (or ``jieba.<submodule>``); raises ImportError naming jieba
    when it is not installed."""
    name = "jieba" if submodule is None else f"jieba.{submodule}"
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"tone sandhi and word segmentation need the jieba package ({name} failed to import: "
            f"{e}); install jieba, or pass precomputed sandhi overrides") from e

PUNCS = "、：，。！？；：,;.?!"

# --- linguistic data (ported from the reference lists, :35-107) -------------

MUST_NEURAL_TONE_WORDS = {
    "麻烦", "麻利", "鸳鸯", "高粱", "骨头", "骆驼", "马虎", "首饰", "馒头", "馄饨", "风筝",
    "难为", "队伍", "阔气", "闺女", "门道", "锄头", "铺盖", "铃铛", "铁匠", "钥匙", "里脊",
    "里头", "部分", "那么", "道士", "造化", "迷糊", "连累", "这么", "这个", "运气", "过去",
    "软和", "转悠", "踏实", "跳蚤", "跟头", "趔趄", "财主", "豆腐", "讲究", "记性", "记号",
    "认识", "规矩", "见识", "裁缝", "补丁", "衣裳", "衣服", "衙门", "街坊", "行李", "行当",
    "蛤蟆", "蘑菇", "薄荷", "葫芦", "葡萄", "萝卜", "荸荠", "苗条", "苗头", "苍蝇", "芝麻",
    "舒服", "舒坦", "舌头", "自在", "膏药", "脾气", "脑袋", "脊梁", "能耐", "胳膊", "胭脂",
    "胡萝", "胡琴", "胡同", "聪明", "耽误", "耽搁", "耷拉", "耳朵", "老爷", "老实", "老婆",
    "老头", "老太", "翻腾", "罗嗦", "罐头", "编辑", "结实", "红火", "累赘", "糨糊", "糊涂",
    "精神", "粮食", "簸箕", "篱笆", "算计", "算盘", "答应", "笤帚", "笑语", "笑话", "窟窿",
    "窝囊", "窗户", "稳当", "稀罕", "称呼", "秧歌", "秀气", "秀才", "福气", "祖宗", "砚台",
    "码头", "石榴", "石头", "石匠", "知识", "眼睛", "眯缝", "眨巴", "眉毛", "相声", "盘算",
    "白净", "痢疾", "痛快", "疟疾", "疙瘩", "疏忽", "畜生", "生意", "甘蔗", "琵琶", "琢磨",
    "琉璃", "玻璃", "玫瑰", "玄乎", "狐狸", "状元", "特务", "牲口", "牙碜", "牌楼", "爽快",
    "爱人", "热闹", "烧饼", "烟筒", "烂糊", "点心", "炊帚", "灯笼", "火候", "漂亮", "滑溜",
    "溜达", "温和", "清楚", "消息", "浪头", "活泼", "比方", "正经", "欺负", "模糊", "槟榔",
    "棺材", "棒槌", "棉花", "核桃", "栅栏", "柴火", "架势", "枕头", "枇杷", "机灵", "本事",
    "木头", "木匠", "朋友", "月饼", "月亮", "暖和", "明白", "时候", "新鲜", "故事", "收拾",
    "收成", "提防", "挖苦", "挑剔", "指甲", "指头", "拾掇", "拳头", "拨弄", "招牌", "招呼",
    "抬举", "护士", "折腾", "扫帚", "打量", "打算", "打点", "打扮", "打听", "打发", "扎实",
    "扁担", "戒指", "懒得", "意识", "意思", "情形", "悟性", "怪物", "思量", "怎么", "念头",
    "念叨", "快活", "忙活", "志气", "心思", "得罪", "张罗", "弟兄", "开通", "应酬", "庄稼",
    "干事", "帮手", "帐篷", "希罕", "师父", "师傅", "巴结", "巴掌", "差事", "工夫", "岁数",
    "屁股", "尾巴", "少爷", "小气", "小伙", "将就", "对头", "对付", "寡妇", "家伙", "客气",
    "实在", "官司", "学问", "学生", "字号", "嫁妆", "媳妇", "媒人", "婆家", "娘家", "委屈",
    "姑娘", "姐夫", "妯娌", "妥当", "妖精", "奴才", "女婿", "头发", "太阳", "大爷", "大方",
    "大意", "大夫", "多少", "多么", "外甥", "壮实", "地道", "地方", "在乎", "困难", "嘴巴",
    "嘱咐", "嘟囔", "嘀咕", "喜欢", "喇嘛", "喇叭", "商量", "唾沫", "哑巴", "哈欠", "哆嗦",
    "咳嗽", "和尚", "告诉", "告示", "含糊", "吓唬", "后头", "名字", "名堂", "合同", "吆喝",
    "叫唤", "口袋", "厚道", "厉害", "千斤", "包袱", "包涵", "匀称", "勤快", "动静", "动弹",
    "功夫", "力气", "前头", "刺猬", "刺激", "别扭", "利落", "利索", "利害", "分析", "出息",
    "凑合", "凉快", "冷战", "冤枉", "冒失", "养活", "关系", "先生", "兄弟", "便宜", "使唤",
    "佩服", "作坊", "体面", "位置", "似的", "伙计", "休息", "什么", "人家", "亲戚", "亲家",
    "交情", "云彩", "事情", "买卖", "主意", "丫头", "丧气", "两口", "东西", "东家", "世故",
    "不由", "不在", "下水", "下巴", "上头", "上司", "丈夫", "丈人", "一辈", "那个", "菩萨",
    "父亲", "母亲", "咕噜", "邋遢", "费用", "冤家", "甜头", "介绍", "荒唐", "大人", "泥鳅",
    "幸福", "熟悉", "计划", "扑腾", "蜡烛", "姥爷", "照顾", "喉咙", "吉他", "弄堂", "蚂蚱",
    "凤凰", "拖沓", "寒碜", "糟蹋", "倒腾", "报复", "逻辑", "盘缠", "喽啰", "牢骚", "咖喱",
    "扫把", "惦记",
}
MUST_NOT_NEURAL_TONE_WORDS = {
    "男子", "女子", "分子", "原子", "量子", "莲子", "石子", "瓜子", "电子", "卵子",
    "王子", "网球王子", "酒井法子", "育有一子", "一子",
}
MUST_ERHUA = {"小院儿", "胡同儿", "范儿", "老汉儿", "撒欢儿", "寻老礼儿", "妥妥儿", "抠门儿", "遛弯儿", "鸟儿", "道儿"}
NOT_ERHUA = {
    "虐儿", "为儿", "护儿", "瞒儿", "救儿", "替儿", "有儿", "一儿", "我儿", "俺儿", "妻儿",
    "拐儿", "聋儿", "乞儿", "患儿", "幼儿", "孤儿", "婴儿", "婴幼儿", "连体儿", "脑瘫儿",
    "流浪儿", "体弱儿", "混血儿", "蜜雪儿", "舫儿", "祖儿", "美儿", "应采儿", "可儿", "侄儿",
    "孙儿", "侄孙儿", "女儿", "男儿", "红孩儿", "花儿", "虫儿", "马儿", "鸟儿", "猪儿", "猫儿", "狗儿",
}

SENTENCE_PARTICLES = "吧哈啊呐噻嘛呐哦哒滴哩哟喽啰耶诶"
DE_WORDS_E2 = {
    "已取得", "取得", "也取得", "获得", "赢得", "难得", "也使得", "使得", "愿得", "夺得",
    "势在必得", "彼得", "摘得", "不值得", "值得", "应得", "罪有应得", "心安理得", "先得",
    "记得", "不记得", "哭笑不得", "所得", "唾手可得", "多劳多得", "立得", "恨不得",
    "志在必得", "不见得", "舍不得", "心得", "引得", "博得", "喜得", "非法所得", "府取得",
    "不舍得", "舍得", "购得", "竞得", "动弹不得", "情非得以",
}
DE_WORDS_EI3 = {"非得", "总得", "不得", "只得", "可得", "我总得", "总得给", "都得", "得亏", "必得"}
DI_NEUTRAL_WORDS = {
    "骄傲地", "幸运地", "偷偷地", "深深地", "愚蠢地", "过早地", "无情地", "奇迹般地",
    "般地", "适时地", "慢慢地", "重重地",
}


class SandhiProcessor:
    def __init__(self, zh_dict: ZhDict):
        self.zh_dict = zh_dict

    # -- pronunciation lookup -------------------------------------------------

    def _readings(self, ch: str) -> list[tuple[str, str]]:
        """[(initial, final_tone3)] for the char's dictionary readings;
        neutral readings carry '5' (pypinyin neutral_tone_with_five=True)."""
        out = []
        for p in self.zh_dict.prons(ch):
            initial, final = pinyin_to_tone3(p)
            if final and not final[-1].isdigit():
                final += "5"
            out.append((initial, final))
        return out

    def _first_final(self, ch: str) -> str:
        r = self._readings(ch)
        return r[0][1] if r else ""

    def _pron_index(self, ch: str, final: str) -> int:
        """1-based index of the char's reading with the given final_tone3
        ('5' = neutral); 0 when absent (the reference would crash here)."""
        for i, (_, f) in enumerate(self._readings(ch)):
            if f == final:
                return i + 1
        return 0

    def _neutral_index(self, ch: str) -> int:
        """1-based index of the char's neutral-tone reading, 0 if none.

        The reference derives the neutral final from pypinyin's most-common
        reading; our finals come from the dict's FIRST reading, whose final
        may differ from the neutral reading's (了: liǎo vs le), so neutral
        rules look the toneless reading up directly."""
        for i, (_, f) in enumerate(self._readings(ch)):
            if f.endswith("5"):
                return i + 1
        return 0

    # -- segmentation merges (reference :268-343,437-443) ---------------------

    @staticmethod
    def _merge_bu(seg):
        new_seg, last = [], ""
        for word, pos in seg:
            if last == "不":
                word = last + word
            if word != "不":
                new_seg.append([word, pos])
            last = word
        if last == "不":
            new_seg.append(["不", "d"])
        return new_seg

    @staticmethod
    def _merge_yi(seg):
        new_seg = []
        for i, (word, pos) in enumerate(seg):
            if (
                0 < i < len(seg) - 1
                and word == "一"
                and seg[i - 1][0] == seg[i + 1][0]
                and seg[i - 1][1] == "v"
                and new_seg
            ):
                new_seg[-1][0] = new_seg[-1][0] + "一" + new_seg[-1][0]
            elif i >= 2 and seg[i - 1][0] == "一" and seg[i - 2][0] == word and pos == "v":
                continue  # already folded by the branch above
            else:
                new_seg.append([word, pos])
        seg, new_seg = new_seg, []
        for word, pos in seg:
            if new_seg and new_seg[-1][0] == "一":
                new_seg[-1][0] = new_seg[-1][0] + word
            else:
                new_seg.append([word, pos])
        return new_seg

    @staticmethod
    def _merge_reduplication(seg):
        new_seg = []
        for word, pos in seg:
            if new_seg and word == new_seg[-1][0]:
                new_seg[-1][0] = new_seg[-1][0] + word
            else:
                new_seg.append([word, pos])
        return new_seg

    @staticmethod
    def _merge_er(seg):
        new_seg = []
        for i, (word, pos) in enumerate(seg):
            if i >= 1 and word == "儿" and new_seg:
                new_seg[-1][0] = new_seg[-1][0] + word
            else:
                new_seg.append([word, pos])
        return new_seg

    @staticmethod
    def pre_merge_for_modify(seg):
        """The reference's pre-merge passes (:437-443); also used by the
        zh_dict text processor for word re-merging (txt_processors/
        zh_dict.py:68-71) so word boundaries match the sandhi indices."""
        seg = SandhiProcessor._merge_bu(seg)
        seg = SandhiProcessor._merge_yi(seg)
        seg = SandhiProcessor._merge_reduplication(seg)
        seg = SandhiProcessor._merge_er(seg)
        return seg

    @staticmethod
    def _split_word(word: str) -> list[str]:
        """Split a word into two subwords at jieba's shortest search-mode
        token (reference _split_word, :265-276)."""
        parts = sorted(require_jieba().cut_for_search(word), key=len)
        if not parts:
            return [word, ""]
        first = parts[0]
        at = word.find(first)
        if at == 0:
            return [first, word[len(first):]]
        return [word[: -len(first)], first]

    # -- rules -----------------------------------------------------------------

    def _bu_sandhi(self, word: str, finals: list[str]):
        idx = [0] * len(word)
        if len(word) == 3 and word[1] == "不":
            finals[1] = finals[1][:-1] + "5"
            idx[1] = self._pron_index("不", finals[1])
        else:
            for i, ch in enumerate(word):
                if ch == "不" and i + 1 < len(word) and finals[i + 1][-1:] == "4":
                    finals[i] = finals[i][:-1] + "2"
                    idx[i] = self._pron_index("不", finals[i])
                elif ch == "不" and finals[i][:1] == "u":
                    finals[i] = finals[i][:-1] + "4"
                    idx[i] = self._pron_index("不", finals[i])
        return finals, idx

    def _yi_sandhi(self, word: str, finals: list[str]):
        idx = [0] * len(word)
        pos_yi = word.find("一")
        if pos_yi != -1 and all(c.isnumeric() for c in word if c != "一"):
            idx[pos_yi] = self._pron_index("一", finals[pos_yi])
            return finals, idx
        if len(word) == 3 and word[1] == "一" and word[0] == word[-1]:
            finals[1] = finals[1][:-1] + "5"
            idx[1] = self._pron_index("一", finals[1])
        elif word.startswith("第一"):
            finals[1] = finals[1][:-1] + "1"
            idx[1] = self._pron_index("一", finals[1])
        elif word in {"一线", "一季度", "十一年", "二一年"}:
            finals[0] = finals[0][:-1] + "1"
            idx[0] = self._pron_index("一", finals[0])
        else:
            for i, ch in enumerate(word):
                if ch == "一" and i + 1 < len(word):
                    tone = "2" if finals[i + 1][-1:] == "4" else "4"
                    finals[i] = finals[i][:-1] + tone
                    idx[i] = self._pron_index("一", finals[i])
        return finals, idx

    def _neural_sandhi(self, word: str, pos: str, finals: list[str]):
        idx = [0] * len(word)

        def set_neutral(j):
            finals[j] = finals[j][:-1] + "5"
            idx[j] = self._neutral_index(word[j])

        # reduplication under n/v/a (e.g. 奶奶, 试试), except 哈哈
        if "哈哈" not in word:
            for j in range(1, len(word)):
                if word[j] == word[j - 1] and pos[:1] in {"n", "v", "a"}:
                    set_neutral(j)
        if word == "处处":
            for j in (0, 1):
                finals[j] = "u4"
                idx[j] = self._pron_index(word[j], "u4")

        last = word[-1]
        if last in SENTENCE_PARTICLES and word not in {"雅马哈", "哒哒"}:
            if not (len(word) > 1 and word[-2] == last):
                finals[-1] = finals[-1][:-1] + "5"
                idx[-1] = self._neutral_index(last)
            else:
                idx[-1] = self._pron_index(last, finals[-1])
        elif last == "么":
            finals[-1] = "e5"
            idx[-1] = self._pron_index(last, "e5") or self._neutral_index(last)
        elif len(word) > 1 and last in "的得":
            if word in DE_WORDS_E2:
                finals[-1] = "e2"
                idx[-1] = self._pron_index(last, "e2")
            elif word in DE_WORDS_EI3:
                finals[-1] = "ei3"
                idx[-1] = self._pron_index(last, "ei3")
            else:
                finals[-1] = finals[-1][:-1] + "5"
                idx[-1] = self._neutral_index(last)
        elif last == "地":
            if len(word) == 1:
                finals[-1] = "e5"
            if pos[:1] == "d" or (pos[:1] == "z" and word != "湿地") or word in DI_NEUTRAL_WORDS:
                finals[-1] = "e5"
            if word == "地地":
                finals = ["i4", "i4"]
            idx[-1] = self._pron_index(last, finals[-1])
        elif len(word) == 1 and word in "了着" and pos in {"ul", "uz", "ug"}:
            set_neutral(0)
        elif len(word) == 1 and word in "的得地" and pos[:1] == "u":
            # standalone structural particles (jieba uj/ud/uv) are neutral;
            # the reference only covers them word-finally (len>1) and leaves
            # a lone 的/得/地 unforced — deliberate coverage improvement
            finals[-1] = "e5"
            idx[-1] = self._pron_index(word, "e5")
        elif len(word) > 1 and last == "子":
            if pos in {"r", "n"} and word not in MUST_NOT_NEURAL_TONE_WORDS:
                set_neutral(len(word) - 1)
            elif pos in {"r", "n", "m"} and word in MUST_NOT_NEURAL_TONE_WORDS:
                finals[-1] = finals[-1][:-1] + "3"
                idx[-1] = self._pron_index(last, finals[-1])
        elif len(word) > 1 and last == "们" and pos in {"r", "n"}:
            set_neutral(len(word) - 1)
        elif len(word) > 1 and last == "儿" and word in MUST_ERHUA:
            set_neutral(len(word) - 1)

        # obligatory neutral-tone words, on jieba-search subwords
        if len(word) > 1:
            parts = self._split_word(word)
            split_at = len(parts[0])
            for i, sub in enumerate(parts):
                if sub and (sub in MUST_NEURAL_TONE_WORDS or sub[-2:] in MUST_NEURAL_TONE_WORDS):
                    j = (split_at if i else 0) + len(sub) - 1
                    if j < len(word):
                        set_neutral(j)
        return finals, idx

    def _merge_erhua(self, finals: list[str], word: str, pos: str) -> list[str]:
        """Erhua gating (reference :400-424). The reference ships the
        final+'r' rewrite commented out, so after the must/not_erhua and POS
        gates the finals pass through unchanged; the gating is kept so the
        rewrite can be switched on."""
        if word not in MUST_ERHUA and (word in NOT_ERHUA or pos in {"a", "j", "nr"}):
            return finals
        if len(finals) != len(word):
            return finals
        return finals

    def modified_tone(self, word: str, pos: str, finals: list[str]):
        finals, i_bu = self._bu_sandhi(word, finals)
        finals, i_yi = self._yi_sandhi(word, finals)
        finals, i_ne = self._neural_sandhi(word, pos, finals)
        return finals, [a + b + c for a, b, c in zip(i_bu, i_yi, i_ne)]

    # -- entry -------------------------------------------------------------------

    def process_sandhi(self, text: str, words=None) -> list[int]:
        """Per-char 1-based forced pronunciation indices (0 = none) for the
        clean text, no BOS/EOS (callers pad)."""
        seg = [[w, p] for w, p in require_jieba("posseg").lcut(text)]
        seg = self.pre_merge_for_modify(seg)
        out = [0] * len(text)
        cursor = 0
        for word, pos in seg:
            if pos == "eng":
                cursor += len(word)  # reference forgets this (:458-460)
                continue
            finals = [self._first_final(c) for c in word]
            if all(finals):
                finals, idx = self.modified_tone(word, pos, finals)
                finals = self._merge_erhua(finals, word, pos)
                for j, v in enumerate(idx):
                    if cursor + j < len(text):
                        out[cursor + j] = v
            cursor += len(word)
        return out


class FixedSandhi:
    """Sandhi overrides computed ahead of time, for a machine without jieba:
    {normalized text: process_sandhi's list}. A text it does not hold raises."""

    def __init__(self, overrides: dict[str, list[int]]):
        self.overrides = overrides

    def process_sandhi(self, text: str, words=None) -> list[int]:
        if text not in self.overrides:
            raise KeyError(f"no precomputed sandhi overrides for {text!r}")
        return list(self.overrides[text])
