"""Time the port's S2PA bank kernels, K1 (s2pa_bank_fwd) and K2
(s2pa_bank_bwd), from several checkouts of the repo on one card, in turns,
on the same seeded inputs.

    python3 scripts/torch_bank_kernels_ab.py ROOT_A ROOT_B [--rounds 2]

Each ROOT is a directory that holds a dicttts_tpu_torch package: this
checkout, or an older commit unpacked with `git archive` into a directory
that .gitignore lists. Each measurement runs in a process of its own that
imports that root's package and builds its kernels from that root's
sources, so two versions never share a process; the roots run in the order
A B B A (A B B A A B ... for more rounds). The cases are the training
geometry (bank 8000 x 96 x 768, N = 60 x 64 = 3840 slots) in bf16 and f32
with corpus-like, uniform and Zipf word ids (chip_smoke.word_ids), and the
serving geometry in bf16 (N = 1000). Inputs, byte bounds
and timers are chip_smoke.py's (bank_case, bank_bound, time_ms_cold,
device_ms): a time is the mean device time of 20 calls of the wrapper, L2
flushed before each; a version that sorts the slots by word id is timed
on the slot order computed beforehand (the kernel alone), and the sort's
device time is measured on its own (`sort_ms`). Each version is also
checked against its own plain version.

Prints one JSON line per run and a table with the card's nvidia-smi name
and power limit. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("bfloat16", "corpus", 3840), ("float32", "corpus", 3840), ("bfloat16", "uniform", 3840),
         ("bfloat16", "zipf", 3840), ("float32", "uniform", 3840), ("float32", "zipf", 3840),
         ("bfloat16", "uniform", 1000))


def worker(root: str) -> dict:
    """One root's measurements, in this process: the inputs, bounds and
    timers are chip_smoke.py's (this checkout's), the kernels the root's."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from dicttts_tpu_torch.ops import s2pa_bank as sb

    torch.backends.cuda.matmul.allow_tf32 = False
    takes_slots = hasattr(sb, "slot_order")
    out = []
    for i, (dt, ids, N) in enumerate(CASES):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + i)
        args, g_ctx, g_w = cs.bank_case(torch.device("cuda"), gen, getattr(torch, dt), N, ids)
        if takes_slots:  # the kernel alone, on the slot order computed beforehand
            slots = sb.slot_order(args[1])
            fwd = lambda: sb._fwd(*args, slots)  # noqa: E731
            bwd = lambda: sb._bwd(*args, g_ctx, g_w, slots)  # noqa: E731
        else:
            fwd = lambda: sb.s2pa_bank_fwd(*args)  # noqa: E731
            bwd = lambda: sb.s2pa_bank_bwd(*args, g_ctx, g_w)  # noqa: E731
        ctx, w = fwd()
        d_qe = bwd()
        torch.cuda.synchronize()
        ctx_p, w_p = sb.s2pa_bank_fwd_plain(*args)
        k1_err = max((w - w_p).abs().max().item(), (ctx.float() - ctx_p.float()).abs().max().item())
        del ctx_p, w_p
        k2_err = (d_qe.float() - sb.s2pa_bank_bwd_plain(*args, g_ctx, g_w).float()).abs().max().item()
        rec = {"case": f"{dt} {ids} N={N}", "distinct_rows": cs.bank_bound(args, False)[3],
               "k1_max_abs_err": k1_err, "k2_max_abs_err": k2_err,
               "k1_ms": cs.time_ms_cold(fwd), "k2_ms": cs.time_ms_cold(bwd),
               "k1_bound_ms": cs.bank_bound(args, False)[0], "k2_bound_ms": cs.bank_bound(args, True)[0]}
        if takes_slots:
            rec["sort_ms"] = cs.device_ms(lambda: sb.slot_order(args[1]))
        out.append(rec)
        del args, g_ctx, g_w, ctx, w, d_qe
        torch.cuda.empty_cache()
    return {"root": root, "device": torch.cuda.get_device_name(0), "cases": out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.roots[0])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    order = []
    for r in range(a.rounds):
        order += a.roots if r % 2 == 0 else a.roots[::-1]
    runs = {root: [] for root in a.roots}
    for root in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs[root].append(rec)
    print(f"K1 / K2 device ms, mean of {a.rounds} runs per root (share of the byte bound); on {smi}")
    for i, (dt, ids, N) in enumerate(CASES):
        first = runs[a.roots[0]][0]["cases"][i]
        print(f"  {dt} {ids} N={N} ({first['distinct_rows']} distinct rows; bounds "
              f"{first['k1_bound_ms']:.4f} / {first['k2_bound_ms']:.4f} ms)")
        for root in a.roots:
            c = [run["cases"][i] for run in runs[root]]
            k1 = sum(x["k1_ms"] for x in c) / len(c)
            k2 = sum(x["k2_ms"] for x in c) / len(c)
            sort = f", sort {sum(x['sort_ms'] for x in c) / len(c):.4f}" if "sort_ms" in c[0] else ""
            print(f"    {root}: K1 {k1:.4f} ({100 * c[0]['k1_bound_ms'] / k1:.1f} %), K2 {k2:.4f} "
                  f"({100 * c[0]['k2_bound_ms'] / k2:.1f} %){sort}; max abs err vs plain "
                  f"{max(x['k1_max_abs_err'] for x in c):.3e} / {max(x['k2_max_abs_err'] for x in c):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
