"""Word ids per training batch of the repo's corpus, as the bank kernels
(K1, K2) see them, against chip_smoke.py's "corpus" ids.

    python scripts/corpus_word_id_stats.py [--data .prod_corpus/binary]

Runs on the CPU. Reads the training split with the port's data pipeline
(dicttts_tpu_torch.data.datasets: TTSBinaryDataset, TTSBatchProvider, the
collater the recipe trains with) at the recipe's batch geometry (60 sentences, 64 word slots,
the 512-frame bucket; .prod_corpus/soak.yaml), and prints for each batch
the slots, the share of pad slots (word id 0), the distinct ids, the ids
used once, and the most frequent id's count; then the same for
chip_smoke.word_ids(..., "corpus") at N = 3840 over a few seeds.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(max_sentences=60, max_tokens=31000, max_frames=512, mel_buckets=[512], txt_buckets=[64],
           gloss_buckets=[96], pinyin_buckets=[8], sentence_buckets=[60], frames_multiple=4,
           use_device_dict_bank=True, seed=1234, sort_by_len=True)


def stats(wt: np.ndarray) -> dict:
    ids, counts = np.unique(wt, return_counts=True)
    return {"slots": int(wt.size), "pad_share": float((wt == 0).mean()), "distinct": int(ids.size),
            "used_once": int((counts == 1).sum()), "max_count": int(counts.max())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=os.path.join(REPO, ".prod_corpus", "binary"))
    a = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from dicttts_tpu_torch.data.datasets import TTSBatchProvider, TTSBinaryDataset

    ds = TTSBinaryDataset(a.data, "train", CFG)
    rows = []
    for b in TTSBatchProvider(ds, CFG, shuffle=True).train_batches():
        rows.append(stats(b["word_tokens"]))
        print("corpus batch", b["word_tokens"].shape, rows[-1])
    full = [r for r in rows if r["slots"] == 3840]
    print(f"corpus: {len(ds)} utterances, {len(rows)} batches; mean pad share "
          f"{np.mean([r['pad_share'] for r in rows]):.4f} (all), "
          f"{np.mean([r['pad_share'] for r in full]):.4f} (3840-slot batches); mean distinct "
          f"{np.mean([r['distinct'] for r in rows]):.1f}")
    for seed in range(4):
        wt = chip_smoke.word_ids(torch.Generator().manual_seed(seed), 3840, "corpus").numpy()
        print(f"chip_smoke corpus ids, seed {seed}", stats(wt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
