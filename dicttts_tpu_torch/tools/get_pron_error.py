"""PER scoring (the reference's scripts/get_pron_error.py).

Counterpart of ``scripts/get_pron_error.py``. Reference mode (the default):
score a test run's meta.csv against a label_set0.csv-format label file
(header; column 4 the phone string ``<BOS> k a3 | er3 ... <EOS>``); meta.csv
column 3 holds the decode, two pinyin tokens per character:

    python -m dicttts_tpu_torch.tools.get_pron_error --pred <infer_out>/meta.csv \\
        --labels data/pron_label/label_set0.csv

Simple mode (``--simple``): name-keyed 3-column CSVs on both sides.
``--show_errors`` prints every mismatched item. Host-only.
"""

from __future__ import annotations

import argparse

from dicttts_tpu_torch.eval.per import (
    edit_distance,
    load_label_set,
    load_labels,
    load_meta_predictions,
    pron_error_rate,
    pron_error_rate_files,
)


def main(argv=None) -> float:
    """Run the command line ``argv``; returns the PER as a fraction."""
    p = argparse.ArgumentParser()
    p.add_argument("--pred", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--simple", action="store_true", help="name-keyed 3-col CSVs")
    p.add_argument("--show_errors", action="store_true")
    args = p.parse_args(argv)
    if args.simple:
        preds = load_labels(args.pred)
        labels = load_labels(args.labels)
        per = pron_error_rate(preds, labels)
        names = sorted(set(preds) & set(labels))
        print(f"| scored {len(names)} items")
        if args.show_errors:
            for name in names:
                d = edit_distance(labels[name], preds[name])
                if d:
                    print(f"{name}: {d} errors\n  ref: {' '.join(labels[name])}\n  hyp: {' '.join(preds[name])}")
    else:
        pred = load_meta_predictions(args.pred)
        gold = load_label_set(args.labels)
        n = min(len(pred), len(gold))
        print(f"| scored {n} items (pred {len(pred)}, gold {len(gold)})")
        if args.show_errors:
            for i in range(n):
                d = edit_distance(pred[i], gold[i])
                if d:
                    print(f"row {i}: {d} errors\n  ref: {' '.join(gold[i])}\n  hyp: {' '.join(pred[i])}")
        per = pron_error_rate_files(args.pred, args.labels)
    print(f"| PER: {per * 100:.2f}%")
    return per


if __name__ == "__main__":
    main()
