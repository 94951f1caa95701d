"""Write the text fixtures that chip_smoke.py uses on a machine without jieba,
computed by the port's front end with jieba and the repo's dictionary
(.prod_corpus/zh-dict.json):

- tests/sandhi_per_test_set.json: the tone-sandhi overrides of the PER test
  sentences (data/per_test_set.json), keyed by their normalized text.
  chip_smoke.py gives them to DictTTSInferencer (``FixedSandhi``);
  tests/test_torch_text.py rebuilds them through the JAX package's engine
  and holds the file to that.
- tests/per_standin_text.json: the pre-align phones and sandhi overrides of
  every sentence that ``dicttts_tpu_torch.tools.per_eval`` generates on
  that dictionary with ``--n_items 300`` (its 50 test sentences and 300
  train/valid ones), keyed by the raw and the normalized text.
  chip_smoke.py phase 15b gives them to per_eval (``FixedText``);
  tests/test_torch_per_tools.py holds the file to the generator and jieba.

    python3 scripts/make_sandhi_fixture.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from dicttts_tpu_torch.text.pinyin import ZhG2P, load_dict  # noqa: E402
from dicttts_tpu_torch.text.sandhi import SandhiProcessor  # noqa: E402


PER_STANDIN_ITEMS = 300


def per_standin_table(dict_path: str, n_items: int = PER_STANDIN_ITEMS) -> dict:
    """per_eval's sentences on ``dict_path`` (seed 0 and the test stream):
    {'dict', 'n_items', 'g2p': {text: {'ph', 'norm'}}, 'sandhi': {text:
    overrides}}, the sandhi under both the raw and the normalized text."""
    import numpy as np

    from dicttts_tpu_torch.tools import per_eval

    zd = load_dict(dict_path)
    het, _ = per_eval._select_heteronyms(zd, 160)
    items = (per_eval._gen_items(zd, het, np.random.RandomState(per_eval.TEST_SEED), per_eval.N_TEST, "t")
             + per_eval._gen_items(zd, het, np.random.RandomState(0), n_items, "h"))
    g2p = ZhG2P(dict_path, pos_merge=True)
    sandhi = SandhiProcessor(zd)
    table = {"dict": os.path.relpath(dict_path, ROOT), "n_items": n_items, "g2p": {}, "sandhi": {}}
    for _, text, _ in items:
        ph, norm = g2p.process(text)
        table["g2p"][text] = {"ph": " ".join(ph), "norm": norm}
        for t in (text, norm):
            table["sandhi"][t] = sandhi.process_sandhi(t, None)
    return table


def main() -> None:
    dict_path = os.path.join(ROOT, ".prod_corpus", "zh-dict.json")
    g2p = ZhG2P(dict_path, pos_merge=True)
    sandhi = SandhiProcessor(load_dict(dict_path))
    with open(os.path.join(ROOT, "data", "per_test_set.json"), encoding="utf-8") as f:
        texts = [d["text"] for d in json.load(f)]
    out = {}
    for text in texts:
        norm = g2p.preprocess(text)
        out[norm] = sandhi.process_sandhi(norm, None)
    path = os.path.join(ROOT, "tests", "sandhi_per_test_set.json")
    lines = [f"{json.dumps(k, ensure_ascii=False)}: {json.dumps(v)}" for k, v in out.items()]
    with open(path, "w", encoding="utf-8") as f:
        f.write("{\n" + ",\n".join(lines) + "\n}\n")
    print(f"wrote {path}: {len(out)} sentences, {sum(v > 0 for o in out.values() for v in o)} overrides")

    table = per_standin_table(dict_path)
    path = os.path.join(ROOT, "tests", "per_standin_text.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(table, f, ensure_ascii=False, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {path}: {len(table['g2p'])} sentences")


if __name__ == "__main__":
    main()
