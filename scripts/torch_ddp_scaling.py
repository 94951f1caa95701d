"""Data-parallel training of the Dict-TTS recipe on W cards against one
card: the same global batches, the same weights, the same draws.

    torchrun --nproc_per_node=4 scripts/torch_ddp_scaling.py [--steps 6] [--rows 60] [--f32-bank]
    torchrun --nproc_per_node=4 scripts/torch_ddp_scaling.py --device cpu --small   # gloo, a dry run

Every rank builds the recipe's ``DictTTSTask`` at full width (``--small``:
tests/test_torch_train_task.py's widths) on chip_smoke's seeded bf16 bank,
joins the group as ``python -m dicttts_tpu_torch.run`` does
(``parallel/mesh.init_distributed``: NCCL on cuda:LOCAL_RANK, gloo on the
CPU) and steps on its rows of phase 7's synthetic batches (``--rows``
sentences of 64 words and 512 frames), dropout 0, the posterior noise and
the crop starts given, deterministic kernels. Then rank 0 alone runs the
same steps in one process on the whole batches, and compares: each step's
losses and gradient norms, and the weights (within 2 lr a step, and
outside the discriminator's instance-normed blocks within 1e-6 plus each
update's Adam term: chip_smoke.update_atol). It prints the step ms (the
card synchronized after each step; the median after the first) on W
cards and on one, the all-reduce of the generator's gradients alone (CUDA
events), peak memory, and one JSON line, also written to
``chiprun_out/ddp_scaling_w<W>_rows<rows>.json``. One card's side takes
cuDNN's FFT convolutions from 49 rows (``PERF.md`` §5), the ranks' do not.

    python scripts/torch_ddp_scaling.py --control [--rows 44] [--f32-bank]

is the control without a process group, on one card: the same steps run
once more as they are (deterministic kernels: no difference expected) and
once from weights moved by one unit in the last place (each element up or
down at random), each compared with the first run as above. It measures
how far the training itself amplifies a rounding difference, which any
other split of the batch (W ranks) also makes; it writes
``chiprun_out/ddp_control_rows<rows>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from dicttts_tpu_torch.parallel import mesh  # noqa: E402
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask  # noqa: E402

SMALL = dict(hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dict_embed_dim=32, dur_predictor_layers=2,
             dur_predictor_kernel=3, latent_size=4, fvae_enc_dec_hidden=16, fvae_kernel_size=3,
             fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8, glow_kernel_size=3,
             prior_glow_n_blocks=1, mel_disc_hidden_size=8)


def build(device, small: bool, f32_bank: bool = False) -> DictTTSTask:
    gen = torch.Generator(device=device).manual_seed(cs.SEED + 11)
    bf16 = device.type == "cuda" and not f32_bank
    bank = cs.make_bank(device, gen, torch.bfloat16 if bf16 else torch.float32)
    if small:
        bank["keys"] = bank["keys"][..., :SMALL["dict_embed_dim"]].contiguous()
    task = DictTTSTask({**cs.DDP_CFG, **(SMALL if small else {})}, bank=bank, device=device)
    task.build_state(cs.SEED + 11)
    return task


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nudge(task, seed: int) -> None:
    """Move every weight one unit in the last place, up or down at random."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in (*task.model.parameters(), *task.disc.parameters()):
            up = (torch.rand(p.shape, generator=gen) < 0.5).to(p.device)
            p.copy_(torch.where(up, torch.nextafter(p, torch.full_like(p, torch.inf)),
                                torch.nextafter(p, torch.full_like(p, -torch.inf))))


def run(task, batches, noise, starts) -> dict:
    """The steps on this rank's rows (all rows in one process)."""
    mesh.broadcast_state(task.state_dict())
    device = task.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    metrics, ms, atol = [], [], {}
    for batch, eps in zip(batches, noise):
        local = task.to_device(mesh.shard_batch(batch))
        sync(device)
        mesh.barrier()
        t = time.perf_counter()
        m = task.train_step(local, None, eps=torch.as_tensor(mesh.shard_batch({"e": eps})["e"]).to(device),
                            start_frames_g=starts.to(device), start_frames_d=starts.to(device))
        sync(device)
        ms.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        for k, v in cs.update_atol(task).items():
            atol[k] = atol.get(k, 0.0) + v
    return {"metrics": metrics, "ms": ms, "atol": atol,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None,
            "params": {f"{i}.{n}": p.detach().cpu().clone() for i, mod in enumerate((task.model, task.disc))
                       for n, p in mod.named_parameters()}}


def compare(got_run: dict, ref: dict) -> dict:
    """Each step's largest relative loss or gradient-norm difference, the
    largest parameter difference, and the elements beyond the Adam bound
    (count, largest, whether in an instance-normed block), per tensor."""
    worst, over, worst_param, by_step = (0.0, ""), {}, 0.0, []
    for i, (got, want) in enumerate(zip(got_run["metrics"], ref["metrics"])):
        rels = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-6) for k in want}
        by_step.append(max(rels.values()))
        for k, rel in rels.items():
            worst = max(worst, (rel, f"step {i} {k}: {got[k]:.7g} vs {want[k]:.7g}"))
    for k, want in ref["params"].items():
        err = (got_run["params"][k] - want).abs()
        worst_param = max(worst_param, float(err.max()))
        n_over = int((err > ref["atol"][k]).sum())
        normed = k.startswith("1.discs.") and any(f".{b}" in k for b in ("conv_1.", "conv_2.", "in_"))
        if n_over:
            over[k] = (n_over, float(err.max()), normed)
    return {"worst": worst, "over": over, "worst_param": worst_param, "by_step": by_step}


def control(args, device, smi, batches, noise, starts) -> int:
    """One card, no group: a repeat of the steps and a run from weights one
    ulp away, each against the first run."""
    with cs.deterministic():
        ref = run(build(device, args.small, args.f32_bank), batches, noise, starts)
        again = run(build(device, args.small, args.f32_bank), batches, noise, starts)
        task = build(device, args.small, args.f32_bank)
        nudge(task, cs.SEED + 13)
        nudged = run(task, batches, noise, starts)
    out = {"rows": args.rows, "frames": batches[0]["mels"].shape[1], "small": args.small,
           "f32_bank": args.f32_bank, "device": smi, "step_ms": ref["ms"]}
    for name, res in (("repeat", again), ("one_ulp", nudged)):
        c = compare(res, ref)
        out[name] = {"worst_rel": c["worst"][0], "worst_at": c["worst"][1], "worst_rel_by_step": c["by_step"],
                     "worst_param": c["worst_param"],
                     "beyond_adam_bound": {k: v[:2] for k, v in c["over"].items()},
                     "beyond_outside_instance_norm": sum(v[0] for v in c["over"].values() if not v[2])}
        print(f"control {name}, {args.rows} rows{', f32 bank' if args.f32_bank else ''}, on {smi}: largest "
              f"relative loss or gradient-norm difference by step {[f'{x:.2e}' for x in c['by_step']]} "
              f"({c['worst'][1]}); largest parameter difference {c['worst_param']:.3e}; elements beyond the "
              f"Adam bound outside the instance-normed blocks "
              f"{out[name]['beyond_outside_instance_norm']}", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = f"ddp_control_rows{args.rows}{'_f32bank' if args.f32_bank else ''}.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    if out["repeat"]["worst_rel"] != 0.0 or out["repeat"]["worst_param"] != 0.0:
        raise AssertionError("two runs of the same steps differ: the kernels are not deterministic")
    return 0


def allreduce_ms(task, iters: int = 10) -> float | None:
    """The generator's gradient all-reduce alone, CUDA events."""
    if task.device.type != "cuda":
        return None
    params = list(task.model.parameters())
    for p in params:
        p.grad = torch.ones_like(p)
    mesh.all_reduce_grads(params)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        mesh.all_reduce_grads(params)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--rows", type=int, default=cs.TRAIN_B)
    p.add_argument("--small", action="store_true")
    p.add_argument("--f32-bank", action="store_true", help="an f32 bank in place of the recipe's bf16")
    p.add_argument("--control", action="store_true",
                   help="one card, no group: a repeat and a run from weights one ulp away")
    args = p.parse_args()
    device = (torch.device(args.device) if args.control
              else mesh.init_distributed(args.device, timeout_s=900))
    world, rank = mesh.world_size(), mesh.rank()
    if args.rows % world:
        raise ValueError(f"--rows {args.rows} is not a multiple of the {world} ranks")
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
           if device.type == "cuda" else "cpu")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    T = 128 if args.small else cs.TRAIN_T
    rng = np.random.RandomState(cs.SEED + 12)
    batches = cs.make_train_batches(rng, args.steps, args.rows, cs.TRAIN_TW, T, cs.BANK_V)
    noise = [rng.randn(args.rows, T // 4, 4 if args.small else 16).astype(np.float32) for _ in batches]
    starts = cs.crop_starts(rng.rand(3), batches[0]["mel_lengths"], T)
    if args.control:
        return control(args, device, smi, batches, noise, starts)
    with cs.deterministic():
        task = build(device, args.small, args.f32_bank)
        dp = run(task, batches, noise, starts)
        reduce_ms = allreduce_ms(task)
        del task
        if device.type == "cuda":
            torch.cuda.empty_cache()
        mesh.barrier()
        mesh.dist.destroy_process_group()
        if rank != 0:
            return 0
        one = run(build(device, args.small, args.f32_bank), batches, noise, starts)  # rank 0 alone, no group
    cmp = compare(dp, one)
    worst, over, worst_param, by_step = cmp["worst"], cmp["over"], cmp["worst_param"], cmp["by_step"]
    med = lambda xs: statistics.median(xs[1:] or xs)  # noqa: E731
    out = {"world": world, "rows": args.rows, "frames": T, "small": args.small, "f32_bank": args.f32_bank,
           "device": smi,
           "ddp_step_ms": dp["ms"], "one_step_ms": one["ms"], "ddp_median_ms": med(dp["ms"]),
           "one_median_ms": med(one["ms"]), "grad_allreduce_ms": reduce_ms, "ddp_peak_gib": dp["peak_gib"],
           "one_peak_gib": one["peak_gib"], "worst_rel": worst[0], "worst_at": worst[1], "worst_rel_by_step": by_step,
           "worst_param": worst_param, "beyond_adam_bound": over}
    print(f"{world} ranks x {args.rows // world} rows vs one process x {args.rows} rows, {T} frames, "
          f"{args.steps} steps; on {smi}:", flush=True)
    print(f"  step ms: ranks {[round(x, 1) for x in dp['ms']]}, one process {[round(x, 1) for x in one['ms']]}; "
          f"medians after the first {out['ddp_median_ms']:.1f} vs {out['one_median_ms']:.1f}; the generator's "
          f"gradient all-reduce alone {reduce_ms} ms; peak {dp['peak_gib']} vs {one['peak_gib']} GiB", flush=True)
    print(f"  largest relative loss or gradient-norm difference {worst[0]:.3e} ({worst[1]}; by step "
          f"{[f'{x:.2e}' for x in by_step]}); largest parameter "
          f"difference {worst_param:.3e}; beyond the Adam bound (elements, largest, instance-normed): {over}",
          flush=True)
    lr_max = 2e-4 * args.steps  # the discriminator's lr, 2 lr a step; the generator's is far smaller
    ok = worst[0] <= 1e-3 and worst_param <= lr_max and all(normed for _, _, normed in over.values())
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = f"ddp_scaling_w{world}_rows{args.rows}{'_f32bank' if args.f32_bank else ''}.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        json.dump(out, f)
    print(json.dumps({k: v for k, v in out.items() if k != "beyond_adam_bound"}), flush=True)
    if not ok:
        raise AssertionError("the ranks' steps differ from one process's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
