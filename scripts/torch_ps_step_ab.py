#!/usr/bin/env python3
"""Time PortaSpeech's train step and inference of two copies of the port, in turns.

    python3 scripts/torch_ps_step_ab.py ROOT_A ROOT_B [--iters 12] [--rounds 2]

Each ROOT holds a ``dicttts_tpu_torch`` package (this repo's root, or a
``git archive`` of another commit unpacked under a gitignored directory).
The copies run A, B, B, A (``--rounds`` 2), each in a fresh process that
imports the package from its ROOT, on one card and one call, so the two
are compared on the same machine. Each process builds the recipe's
``PortaSpeechAdvTask`` (``configs/tts/ps_adv.yaml``'s widths, seed 0) and
``PortaSpeechFlowTask`` with the post-glow, and times on the host clock,
synchronised around each call, the median of ``--iters`` calls after 3
warm-up ones: a ps_adv train step on a 40 x 512 word batch (below the
batch of 49 where cuDNN's FFT path takes over, so the step is bound by
the host and by launches), ps_adv ``test_step`` and ps_flow ``test_step``
with the Glow's sample on one 384-frame row. The batches are
``chip_smoke.ps_batch``'s, from numpy seed 0. Prints one JSON line per
process and the medians per root. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root: str, iters: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, REPO)  # chip_smoke.ps_batch from this checkout
    import numpy as np
    import torch

    import dicttts_tpu_torch
    from chip_smoke import ps_batch
    from dicttts_tpu_torch.train.tasks.ps_adv import PortaSpeechAdvTask
    from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask

    assert os.path.abspath(dicttts_tpu_torch.__file__).startswith(os.path.abspath(root))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    rng = np.random.RandomState(0)
    train = ps_batch(rng, 40, 96, 40, 512)
    row = ps_batch(rng, 1, 64, 28, 512)
    out = {"root": root}
    adv = PortaSpeechAdvTask({"n_vocab": 170}, device="cuda")
    adv.build_state(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = adv.to_device(train)
    out["ps_adv_train_40x512_ms"] = median_ms(lambda: adv.train_step(batch, gen))
    one = adv.to_device(row)
    out["ps_adv_test_step_ms"] = median_ms(lambda: adv.test_step(one, gen))
    del adv, batch
    flow = PortaSpeechFlowTask({"n_vocab": 170, "use_post_glow": True}, device="cuda")
    flow.build_state(0)
    out["ps_flow_test_step_ms"] = median_ms(lambda: flow.test_step(flow.to_device(row), gen))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.iters)), flush=True)
        return 0
    a, b = args.roots
    order = [a, b, b, a] * (args.rounds // 2) + ([a, b] if args.rounds % 2 else [])
    results = []
    for root in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                              "--iters", str(args.iters)], capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    keys = [k for k in results[0] if k != "root"]
    summary = {root: {k: statistics.median(r[k] for r in results if r["root"] == root) for k in keys}
               for root in (a, b)}
    print(json.dumps({"medians": summary, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
