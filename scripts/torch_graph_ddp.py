"""Data-parallel training of the Dict-TTS recipe's task in groups of K
steps (``steps_per_dispatch``) against K = 1: W ranks, the same batches.

    python scripts/torch_graph_ddp.py [--world 4] [--k 16] [--rows 64]   # NCCL, one card a rank
    python scripts/torch_graph_ddp.py --device cpu --world 4 --small     # gloo, a dry run

Each rank joins the group as torchrun would start it (MASTER_ADDR/PORT,
WORLD_SIZE, RANK, LOCAL_RANK: NCCL on cuda:LOCAL_RANK, gloo on the CPU)
and builds the recipe's ``DictTTSTask`` at full width (``--small``:
tests/test_torch_train_task.py's widths on a small bank) on chip_smoke's
seeded bank, the discriminator from step DISC_START on every second step
(the NaN step below is not one of them: a discriminator update is not
skipped on the generator's non-finite loss, and one on NaN mels would end
the run's finite steps). Then ``Trainer.fit``
runs STEPS global batches of ``--rows`` sentences in two shapes, in runs
that make groups end at a shape change (the odd batch re-queued), at a
validation mark inside a run and at ``max_updates``, with a NaN in one
rank's rows of a batch inside a group, first at K = 1, then at K = --k,
deterministic kernels. On the card the grouped run's steps replay CUDA
graphs (``train/graphs.py``), so the gradient all-reduce and the metric
reductions run inside the graphs, between the eager collectives of the
warm-ups and the validations.

Checked on every rank, K against 1: every step's losses, bit for bit; the
final state (weights, both Adam moments, the counts, the lr), bit for bit,
and equal to rank 0's; the same groups and checkpoint steps on every rank;
the NaN step skipped on every rank; K1 and K2 once a step, replays
counted. It prints the graphs, replays, step ms by how the step ran and
``steady_per_step_s``, and one JSON line, also written to
``chiprun_out/graph_ddp_w<W>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SMALL = dict(hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dict_embed_dim=32, dur_predictor_layers=2,
             dur_predictor_kernel=3, latent_size=4, fvae_enc_dec_hidden=16, fvae_kernel_size=3,
             fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8, glow_kernel_size=3,
             prior_glow_n_blocks=1, mel_disc_hidden_size=8)
# the batches' shapes, in runs: (shape index, steps); a validation mark at step 7, inside the second run
RUNS = ((0, 5), (1, 3), (0, 6), (1, 4), (0, 2))
STEPS, VAL_EVERY, DISC_START, DISC_INTERVAL, NAN_STEP = 20, 7, 2, 2, 12
FRAMES = {False: (256, 512), True: (64, 128)}  # by --small
WORDS = 32


def batches(rows: int, world: int, small: bool) -> list:
    """The global batches: RUNS of two frame widths, a NaN in rank 1's rows
    of step NAN_STEP's mels."""
    rng = np.random.RandomState(cs.SEED + 21)
    shapes = [cs.make_train_batches(rng, STEPS, rows, WORDS, t, cs.BANK_V) for t in FRAMES[small]]
    out, i = [], 0
    for shape, n in RUNS:
        out += shapes[shape][i:i + n]
        i += n
    out[NAN_STEP - 1]["mels"][rows // world + 1, 5, 7] = np.nan
    return out


def run(task_cfg, device, work, k, data) -> dict:
    """Trainer.fit at K = k; this rank's record of it."""
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
    from dicttts_tpu_torch.train.trainer import Trainer
    from dicttts_tpu_torch.utils import checkpoint as ckpt_mod

    bank = cs.make_bank(device, torch.Generator(device=device).manual_seed(cs.SEED + 21),
                        torch.bfloat16 if device.type == "cuda" else torch.float32)
    task = DictTTSTask(task_cfg, bank=bank, device=device)
    trainer = Trainer(os.path.join(work, f"k{k}"), max_updates=STEPS, val_check_interval=VAL_EVERY,
                      num_sanity_val_steps=0, device=device, steps_per_dispatch=k)
    written, save = [], ckpt_mod.save_checkpoint
    ckpt_mod.save_checkpoint = lambda *a, **kw: written.append(a[1]) or save(*a, **kw)
    try:
        with cs.recorded_steps() as steps:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            cs.zero_launch_counts()
            t = time.perf_counter()
            trainer.fit(task, data, data[:1])
            seconds = time.perf_counter() - t
            steps = cs.to_cpu(steps)
    finally:
        ckpt_mod.save_checkpoint = save
    report = trainer.graph_report or {"graphs": [], "replays": 0, "capture_s": 0.0}
    return {"steps": steps, "state": cs.to_cpu(task.state_dict()), "launches": cs.launch_counts(),
            "groups": [(h["group"], h["group_size"]) for h in trainer.history],
            "ms": [(h["run"], round(h["step_ms"], 3)) for h in trainer.history],
            "steady_per_step_s": trainer.steady_per_step_s, "seconds": seconds, "written": written,
            "updates": (task.updates_g, task.updates_d), "device": device.type,
            "graphs": [{k_: g[k_] for k_ in ("key", "capture_s", "replays", "nodes")} for g in report["graphs"]],
            "replays": report["replays"], "capture_s": report["capture_s"]}


def rank_main(local: int, world: int, port: int, device_kind: str, k: int, rows: int, small: bool,
              out: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(local),
                      LOCAL_RANK=str(local))
    if device_kind == "cpu":
        torch.set_num_threads(1)
    if small:
        cs.BANK_V, cs.BANK_L, cs.BANK_E = 512, 16, SMALL["dict_embed_dim"]
    from dicttts_tpu_torch.parallel import mesh

    device = mesh.init_distributed(device_kind, timeout_s=600)
    cfg = {"disc_start_steps": DISC_START, "disc_interval": DISC_INTERVAL, **(SMALL if small else {})}
    data = batches(rows, world, small)
    result = {}
    try:
        with cs.deterministic(), tempfile.TemporaryDirectory(prefix=f"graph_ddp_{local}_") as work:
            for kk in (1, k):
                mesh.barrier()
                result[kk] = run(cfg, device, work, kk, data)
    finally:
        mesh.dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{local}.pt"))


def check(ranks: list, k: int) -> dict:
    """K against 1 on every rank, and every rank against rank 0."""
    from dicttts_tpu_torch.utils.checkpoint import bit_differences

    problems = []
    for r, res in enumerate(ranks):
        one, grouped = res[1], res[k]
        step_diff = [i + 1 for i, (a, b) in enumerate(zip(one["steps"], grouped["steps"])) if bit_differences(a, b)]
        state_diff = bit_differences(one["state"], grouped["state"])
        if step_diff or state_diff or len(one["steps"]) != STEPS or len(grouped["steps"]) != STEPS:
            problems.append(f"rank {r}: K={k} differs from K=1 at steps {step_diff[:5]}, in {state_diff[:5]}")
        for kk in (1, k):
            rec = res[kk]
            if np.isfinite(float(rec["steps"][NAN_STEP - 1]["total_loss"])) or rec["updates"][0] != STEPS - 1:
                problems.append(f"rank {r} K={kk}: step {NAN_STEP} (NaN) not skipped: {rec['updates']}")
            k1, k2, k3 = rec["launches"]  # the kernels' launches (none on the CPU)
            if rec["device"] == "cuda" and (k2 != STEPS or k1 < STEPS or k3):
                problems.append(f"rank {r} K={kk}: K1/K2 not once a step: {rec['launches']}")
            if r and (bit_differences(rec["state"], ranks[0][kk]["state"]) or rec["groups"] != ranks[0][kk]["groups"]):
                problems.append(f"rank {r} K={kk}: state or groups differ from rank 0's")
    if ranks[0][1]["written"] != ranks[0][k]["written"] or any(res[k]["written"] for res in ranks[1:]):
        problems.append(f"checkpoint steps: K=1 {ranks[0][1]['written']}, K={k} {ranks[0][k]['written']}, "
                        f"other ranks {[res[k]['written'] for res in ranks[1:]]}")
    if max(size for _, size in ranks[0][k]["groups"]) < 2:
        problems.append("no group of K > 1 formed")
    return {"problems": problems}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--k", type=int, default=16)
    p.add_argument("--rows", type=int, default=64)
    p.add_argument("--small", action="store_true")
    args = p.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        raise RuntimeError(f"{args.world} ranks need {args.world} cards; {torch.cuda.device_count()} found")
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
           if args.device == "cuda" else "cpu")
    with tempfile.TemporaryDirectory(prefix="graph_ddp_") as out:
        t = time.time()
        torch.multiprocessing.spawn(rank_main, args=(args.world, cs.free_port(), args.device, args.k, args.rows,
                                                     args.small, out), nprocs=args.world, join=True)
        seconds = time.time() - t
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(args.world)]
    verdict = check(ranks, args.k)
    lead = ranks[0]
    by_run = {}
    for kk in (1, args.k):
        for how, ms in lead[kk]["ms"][1:]:
            by_run.setdefault(f"K={kk} {how}", []).append(ms)
    summary = {
        "world": args.world, "k": args.k, "rows": args.rows, "small": args.small, "device": smi,
        "seconds": seconds, "groups": {kk: [size for _, size in lead[kk]["groups"]] for kk in (1, args.k)},
        "written": lead[args.k]["written"], "launches": {kk: lead[kk]["launches"] for kk in (1, args.k)},
        "graphs": lead[args.k]["graphs"], "replays": lead[args.k]["replays"], "capture_s": lead[args.k]["capture_s"],
        "step_ms_median_by_run": {key: statistics.median(v) for key, v in by_run.items()},
        "steady_per_step_s": {kk: lead[kk]["steady_per_step_s"] for kk in (1, args.k)},
        "equal_to_the_bit": not verdict["problems"], "problems": verdict["problems"]}
    print(f"{args.world} ranks x {args.rows // args.world} rows, K={args.k} against K=1 over {STEPS} steps; "
          f"on {smi}:", flush=True)
    for g in summary["graphs"]:
        print(f"  graph {g['key']}: captured in {g['capture_s'] * 1e3:.1f} ms, replayed {g['replays']} times, "
              f"nodes {g['nodes']}", flush=True)
    print(f"  groups {summary['groups']}; checkpoints at {summary['written']}; launches (K1, K2, K3) "
          f"{summary['launches']}; step ms medians after the first {summary['step_ms_median_by_run']}; "
          f"steady_per_step_s {summary['steady_per_step_s']}", flush=True)
    print(f"  every step's losses and the final state bit for bit on every rank: "
          f"{summary['equal_to_the_bit']} {verdict['problems']}", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"graph_ddp_w{args.world}.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps(summary), flush=True)
    return 0 if summary["equal_to_the_bit"] else 1


if __name__ == "__main__":
    sys.exit(main())
