"""Port parity of the Chinese text front end (dicttts_tpu_torch.text) against
the JAX package's (dicttts_tpu.text), on the repo's own dictionary
(.prod_corpus/zh-dict.json) and the PER test sentences
(data/per_test_set.json). The port copies host code, so everything here
is exact: NSW normalization in both modes, the number readers, the
strict and non-strict pinyin splits of every reading in the dictionary,
g2p preprocess/process, and tone sandhi. Also: sandhi without jieba
raises an ImportError that names it, and the committed sandhi fixture
(tests/sandhi_per_test_set.json, which chip_smoke.py feeds the inferencer
on a machine without jieba) equals what the JAX engine computes now.
"""

import json
import os
import sys

import pytest

from dicttts_tpu.text import pinyin as jpinyin
from dicttts_tpu.text import sandhi as jsandhi
from dicttts_tpu.text import text_norm as jnorm
from dicttts_tpu_torch.text import pinyin as tpinyin
from dicttts_tpu_torch.text import sandhi as tsandhi
from dicttts_tpu_torch.text import text_norm as tnorm

ROOT = os.path.join(os.path.dirname(__file__), "..")
DICT = os.path.join(ROOT, ".prod_corpus", "zh-dict.json")
FIXTURE = os.path.join(os.path.dirname(__file__), "sandhi_per_test_set.json")
with open(os.path.join(ROOT, "data", "per_test_set.json"), encoding="utf-8") as _f:
    PER_TEXTS = [d["text"] for d in json.load(_f)]

# the inputs of tests/test_text_norm_categories.py and test_text_norm_strict.py
NSW_CASES = [
    "固话0595-23865596", "手机+86 19859213959", "32/76", "80.03%", "有62％的概率",
    "编号31520181154418", "2983.07克", "1999年2月20日", "09年3月15号", "34.5元", "12块5",
    "40多块钱", "20.1万", "O2O和B2C", "3456万吨", "今天吃了115个小笼包", "200个", "22个",
    "编号2048", "12306订票", "房间号是1001", "密码是83749921", "3:15开会", "12:00整",
    "2022年1月5日", "89年3月7日", "10月10日", "这件衣服12块5", "花了34.5元", "共1000000元",
    "大概30多块钱", "电话13812345678", "占比3/4", "涨了20%", "1.5倍", "0.5毫米", "1/3的人",
    "他有2个苹果", "200斤", "2只猫", "一共115元", "15个人", "今年55岁", "第15名",
    "¥5的东西3-5个", "ＡＢＣ，abc！", "",
]
# the 不/一 and neutral-tone cases of tests/test_sandhi_reference.py
SANDHI_CASES = ["不是", "不好", "看不懂", "一样", "一天", "第一名", "看一看", "二一零", "走了",
                "我的书", "值得", "桌子", "电子", "我们", "妈妈", "他的枕头", "鸟儿", "女儿",
                "我不知道了", "一模一样", "说一说", "不一定", "一个", "第一"]
# the readings of those cases' characters, as a standard dictionary lists
# them: the repo's dictionary gives these characters other readings, so
# the rules seldom find the reading they force there
RULE_READINGS = {
    "不": "bù bú bu fǒu", "是": "shì", "好": "hǎo hào", "看": "kàn kān", "懂": "dǒng",
    "一": "yī yí yì yi", "样": "yàng", "天": "tiān", "第": "dì", "名": "míng", "二": "èr",
    "零": "líng", "走": "zǒu", "了": "liǎo le", "我": "wǒ", "的": "de dí dì", "书": "shū",
    "值": "zhí", "得": "dé de děi", "桌": "zhuō", "子": "zǐ zi", "电": "diàn", "们": "mén men",
    "妈": "mā ma", "他": "tā", "枕": "zhěn", "头": "tóu tou", "鸟": "niǎo", "儿": "ér r",
    "女": "nǚ", "知": "zhī", "道": "dào", "模": "mó mú", "说": "shuō", "定": "dìng", "个": "gè ge",
}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("cases", ["nsw", "per_test_set"])
def test_nsw_normalizer_matches_jax(strict, cases):
    texts = NSW_CASES if cases == "nsw" else PER_TEXTS
    for text in texts:
        for remove_punc in (False, True):
            want = jnorm.NSWNormalizer(text).normalize(remove_punc, strict_reference=strict)
            got = tnorm.NSWNormalizer(text).normalize(remove_punc, strict_reference=strict)
            assert got == want, (text, strict, remove_punc)
    assert [tnorm.normalize_text(t) for t in texts] == [jnorm.normalize_text(t) for t in texts]


def test_number_readers_match_jax():
    nums = [*range(0, 2100), *(7 ** k for k in range(1, 18)), *(10 ** k for k in range(14)),
            20000, 200000000, 1002003004, 10010]
    for n in nums:
        assert tnorm.num2chn(n) == jnorm.num2chn(n), n
        assert tnorm.digits2chn(str(n)) == jnorm.digits2chn(str(n)), n
        assert tnorm.chn2num(jnorm.num2chn(n)) == jnorm.chn2num(jnorm.num2chn(n)), n
    for s in ("0.5", "12.30", "3", "1000.07", "05", "00", "20.1", "2"):
        assert tnorm.number2chn(s) == jnorm.number2chn(s), s
        assert tnorm.ref_cardinal(s) == jnorm.ref_cardinal(s), s


def test_pinyin_splits_of_every_dictionary_reading_match_jax():
    zh = tpinyin.load_dict(DICT)
    readings = sorted({p for char in zh.entries for p in zh.prons(char)})
    assert len(readings) > 1000
    for strict in (False, True):
        got = [tpinyin.pinyin_to_tone3(p, strict=strict) for p in readings]
        assert got == [jpinyin.pinyin_to_tone3(p, strict=strict) for p in readings]
    assert [tpinyin.strip_tone(p) for p in readings] == [jpinyin.strip_tone(p) for p in readings]
    jz = jpinyin.load_dict(DICT)
    assert len(zh) == len(jz) and zh.entries == jz.entries


@pytest.mark.parametrize("pos_merge", [True, False])
def test_g2p_preprocess_and_process_match_jax(pos_merge):
    texts = PER_TEXTS[:20] + NSW_CASES[:10] + ["我们在O2O平台上买了2个苹果。", "你好，世界！"]
    for strict in (False, True):
        tg = tpinyin.ZhG2P(DICT, pos_merge=pos_merge, strict_nsw=strict)
        jg = jpinyin.ZhG2P(DICT, pos_merge=pos_merge, strict_nsw=strict)
        for text in texts:
            assert tg.preprocess(text) == jg.preprocess(text), text
            assert tg.process(text) == jg.process(text), text


@pytest.mark.parametrize("dictionary", ["repo", "rule_readings"])
def test_sandhi_matches_jax_on_the_per_sentences_and_rule_cases(dictionary, tmp_path):
    path = DICT
    if dictionary == "rule_readings":
        path = str(tmp_path / "zh-dict.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({c: {r: ["."] for r in rs.split()} for c, rs in RULE_READINGS.items()}, f,
                      ensure_ascii=False)
    tsp = tsandhi.SandhiProcessor(tpinyin.load_dict(path))
    jsp = jsandhi.SandhiProcessor(jpinyin.load_dict(path))
    g2p = tpinyin.ZhG2P(DICT, pos_merge=True)
    texts = [g2p.preprocess(t) for t in PER_TEXTS] + SANDHI_CASES
    n_forced = 0
    for text in texts:
        got = tsp.process_sandhi(text, None)
        assert got == jsp.process_sandhi(text, None), text
        assert len(got) == len(text)
        n_forced += sum(v > 0 for v in got)
    if dictionary == "rule_readings":
        assert n_forced > 20  # the cases exercise the rules
    seg = [["不", "d"], ["好", "a"], ["看", "v"], ["一", "m"], ["看", "v"], ["鸟", "n"], ["儿", "n"]]
    assert (tsandhi.SandhiProcessor.pre_merge_for_modify([list(s) for s in seg])
            == jsandhi.SandhiProcessor.pre_merge_for_modify([list(s) for s in seg]))


def test_sandhi_without_jieba_raises_naming_it(monkeypatch):
    sp = tsandhi.SandhiProcessor(tpinyin.load_dict(DICT))
    for name in ("jieba", "jieba.posseg"):
        monkeypatch.setitem(sys.modules, name, None)  # as if jieba were not installed
    with pytest.raises(ImportError, match="jieba"):
        sp.process_sandhi("我不知道", None)
    with pytest.raises(ImportError, match="jieba"):
        tpinyin.ZhG2P(DICT, pos_merge=True).process("我不知道")


def test_sandhi_fixture_is_what_the_jax_engine_computes():
    """The committed overrides of the 50 PER sentences, keyed by their
    normalized text, rebuilt through the JAX front end."""
    with open(FIXTURE, encoding="utf-8") as f:
        fixture = json.load(f)
    jg = jpinyin.ZhG2P(DICT, pos_merge=True)
    jsp = jsandhi.SandhiProcessor(jpinyin.load_dict(DICT))
    want = {}
    for text in PER_TEXTS:
        norm = jg.preprocess(text)
        want[norm] = jsp.process_sandhi(norm, None)
    assert fixture == want
