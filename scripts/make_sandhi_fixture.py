"""Write tests/sandhi_per_test_set.json: the tone-sandhi overrides of the
PER test sentences (data/per_test_set.json), keyed by their normalized
text, computed by the port's front end with jieba and the repo's
dictionary (.prod_corpus/zh-dict.json).

chip_smoke.py gives them to DictTTSInferencer (``FixedSandhi``) on a
machine without jieba; tests/test_torch_text.py rebuilds them through the
JAX package's engine and holds the file to that.

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


if __name__ == "__main__":
    main()
