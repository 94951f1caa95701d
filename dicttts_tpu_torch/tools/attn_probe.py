"""Per-slot S2PA attention anatomy of a trained per_eval experiment.

Counterpart of ``scripts/attn_probe.py``: at heteronym slots, is the
pronunciation attention diffuse (sense masses near uniform: a weak learning
signal) or sharp but wrong (confidently mistaken)? Runs the experiment's
newest checkpoint through ``DictTTSTask.test_step`` over the split's
items, reduces each slot's ``pron_attn`` by the batch's ``pinyin_map`` into
per-reading masses, margin, normalised entropy and top-p on the device
(``slot_sense_stats``), and prints them split by correctness against the
per_eval labels (``<root>/labels.csv``, or ``labels_<split>.csv``).

    python -m dicttts_tpu_torch.tools.attn_probe [--exp per_eval_r05] [--n 30]
        [--split test] [--root .per_corpus] [--device cuda]

Writes ``<root>/attn_probe_<split>.json``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def slot_sense_stats(w: torch.Tensor, sense_ids: torch.Tensor) -> dict:
    """Per-slot reading statistics, on ``w``'s device, in f64.

    w [..., P]: a slot's pronunciation weights; sense_ids [..., P]: the
    reading each pinyin token belongs to (1-based, 0 for padding). A slot
    has ``n_senses`` = its largest id; reading s's mass is the mean weight
    of its tokens (0 without tokens), and p the masses normalised. Returns
    {'masses' [..., S], 'p' [..., S] (S the largest id of all slots; zero
    past a slot's own n_senses), 'n_senses', 'pred' (the 0-based argmax of
    p, the first on ties), 'margin' (top p minus the second), 'entropy'
    (of p over log(max(n_senses, 2))), 'top_p', 'valid' (n_senses > 0 and a
    positive mass)}, each [...]."""
    w = w.double()
    sense_ids = sense_ids.long()
    n_senses = sense_ids.amax(-1)
    S = max(int(n_senses.max()), 1)
    ids = torch.arange(1, S + 1, device=w.device)
    onehot = (sense_ids[..., None] == ids).double()  # [..., P, S]
    counts = onehot.sum(-2)
    masses = torch.where(counts > 0, (w[..., None] * onehot).sum(-2) / counts.clamp(min=1), 0.0)
    total = masses.sum(-1)
    valid = (n_senses > 0) & (total > 0)
    p = masses / torch.where(total > 0, total, 1.0)[..., None]
    top2 = p.topk(min(2, S), dim=-1).values
    margin = top2[..., 0] - (top2[..., 1] if S > 1 else 0.0)
    entropy = -(p * torch.log(p.clamp(min=1e-9))).sum(-1) / torch.log(n_senses.clamp(min=2).double())
    return {"masses": masses, "p": p, "n_senses": n_senses, "pred": p.argmax(-1), "margin": margin,
            "entropy": entropy, "top_p": p.amax(-1), "valid": valid}


def load_task(work_dir: str, split: str, device: str):
    """The experiment's task on ``device`` with its newest checkpoint, and
    its data provider with ``split`` as the test split. Returns (cfg, data,
    task, step)."""
    from dicttts_tpu_torch.config import load_config
    from dicttts_tpu_torch.run import autoconfigure_vocabs, build_data_provider, task_class
    from dicttts_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

    cfg = load_config(config=os.path.join(work_dir, "config.yaml"), save=False)
    cfg.update(work_dir=work_dir, use_device_frame_cache=False, test_set_name=split)
    autoconfigure_vocabs(cfg)
    data = build_data_provider(cfg)
    task = task_class(cfg["task_cls"])(cfg, data, device=device)
    task.build_state(0)
    last = get_last_checkpoint(work_dir)
    if last is None:
        raise FileNotFoundError(f"no checkpoint in {work_dir}")
    step, state = load_checkpoint(last, map_location=task.device)
    task.load_state_dict(state)
    return cfg, data, task, step


def main(argv=None) -> dict:
    """Run the command line ``argv``; returns a summary: slots by
    correctness, their statistics' means, the diffuse count."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--exp", default="per_eval_r05")
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--split", default="test")
    ap.add_argument("--root", default=os.path.join(REPO, ".per_corpus"), help="per_eval's --root")
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from dicttts_tpu_torch.eval.per import parse_label_ph
    from dicttts_tpu_torch.text.pinyin import load_dict, pinyin_to_tone3

    cfg, data, task, step = load_task(os.path.join(REPO, "checkpoints", args.exp), args.split, args.device)
    print(f"| probe: checkpoint step {step} on {task.device}", flush=True)
    zd = load_dict(cfg["dict_path"])

    label_fn = os.path.join(args.root, "labels.csv" if args.split == "test" else f"labels_{args.split}.csv")
    gold_by_name = {}
    if os.path.exists(label_fn):
        with open(label_fn, encoding="utf-8") as f:
            for row in csv.DictReader(f):
                gold_by_name[row["item_name"]] = parse_label_ph(row["ph"])

    t3cache = {}

    def t3(s):
        if s not in t3cache:
            ini, fin = pinyin_to_tone3(s)
            t3cache[s] = ini + fin
        return t3cache[s]

    stats = {"correct": [], "wrong": []}
    rows = []
    for bi, batch in enumerate(data.test_batches()):
        if bi >= args.n:
            break
        metas = batch.get("_meta", [{}])
        dev = task.to_device({k: v for k, v in batch.items() if k != "_meta"})
        out = task.test_step(dev, torch.Generator(device=task.device).manual_seed(1))
        dm = task._dict_msg(task.prepare_batch(dev))
        st = {k: v.cpu().numpy() for k, v in slot_sense_stats(out["pron_attn"], dm.pinyin_map).items()}
        for b, meta in enumerate(metas):
            txt = meta.get("txt", "")
            syls = gold_by_name.get(meta.get("item_name", ""), [])
            for j, ch in enumerate(txt):
                prons = zd.prons(ch) if ch in zd.entries else []
                s = (b, j + 1)  # skip the BOS row
                if len(prons) < 2 or not st["valid"][s]:
                    continue
                gold_syl = syls[j] if j < len(syls) else None
                gold_sense = next((si for si, pr in enumerate(prons) if t3(pr) == gold_syl), None)
                if gold_sense is None:
                    continue
                pred_sense = int(st["pred"][s])
                p = st["p"][s][:int(st["n_senses"][s])]
                stats["correct" if pred_sense == gold_sense else "wrong"].append(
                    (float(st["margin"][s]), float(st["entropy"][s]), float(st["top_p"][s])))
                rows.append({"char": ch, "gold": gold_sense, "pred": pred_sense,
                             "p": [round(float(x), 3) for x in p],
                             "margin": round(float(st["margin"][s]), 3)})

    summary = {"step": step, "device": str(task.device)}
    for k, v in stats.items():
        summary[k] = len(v)
        if v:
            m = np.asarray(v)
            summary[f"{k}_means"] = {"margin": float(m[:, 0].mean()), "entropy": float(m[:, 1].mean()),
                                     "top_p": float(m[:, 2].mean())}
            print(f"{k}: n={len(v)} margin mean={m[:,0].mean():.3f} "
                  f"median={np.median(m[:,0]):.3f} | norm-entropy mean={m[:,1].mean():.3f} "
                  f"| top-p mean={m[:,2].mean():.3f}", flush=True)
    diffuse = [r for r in rows if r["margin"] < 0.2]
    summary["diffuse"] = len(diffuse)
    print(f"slots with margin<0.2 (diffuse): {len(diffuse)}/{len(rows)}")
    out_fn = os.path.join(args.root, f"attn_probe_{args.split}.json")
    with open(out_fn, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False, indent=0)
    print("| wrote", out_fn)
    return summary


if __name__ == "__main__":
    main()
