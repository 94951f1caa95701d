"""Time the port's S2PA kernels from several checkouts of the repo on one
card, in turns, on the same seeded inputs: the bank kernels K1
(s2pa_bank_fwd) and K2 (s2pa_bank_bwd), and the fused forward K3
(s2pa_fused).

    python3 scripts/torch_bank_kernels_ab.py ROOT_A ROOT_B [--rounds 2] [--kernels all|bank|fused]
    python3 scripts/torch_bank_kernels_ab.py --profile ROOT [ROOT ...]

Each ROOT is a directory that holds a dicttts_tpu_torch package: this
checkout, or an older commit unpacked with `git archive` into a directory
that .gitignore lists. Each measurement runs in a process of its own that
imports that root's package and builds its kernels from that root's
sources, so two versions never share a process; the roots run in the order
A B B A (A B B A A B ... for more rounds).

K1/K2 cases: the training geometry (bank 8000 x 96 x 768, N = 60 x 64 =
3840 slots) in bf16 and f32 with corpus-like, uniform and Zipf word ids
(chip_smoke.word_ids), and the serving geometry in bf16 (N = 1000). A time
is the mean device time of 20 calls of the wrapper, L2 flushed before each
(chip_smoke.time_ms_cold); a version that sorts the slots by word id is
timed on the slot order computed beforehand (the kernel alone), and the
sort's device time is measured on its own (`sort_ms`).

K3 cases (f32, H = 192, P = 8): the text path at B=1 (Tw 32, L 48: the
largest of chip_smoke's B=1 calls) and at B=16 (Tw 32, L 56), with the text
path's mask layout (chip_smoke.text_layout: its share of padded gloss
tokens and of all-masked pad words), and phase 3's synthetic B=16, T=64,
L=96. A time is the kernel's own device time per call with L2 flushed
before each (torch.profiler, chip_smoke.device_ms): the wrapper's host time
exceeds the kernel's, so CUDA events around each call count the host's
gaps. Beside it: events around each call after the flush, all queued
before one synchronize (chip_smoke.time_ms_cold), and around 20
back-to-back calls (warm L2: the text cases' inputs fit in the 50 MB L2);
and the device time again with ~0.15 s of matmuls queued just ahead, so
the card comes to the calls busy (chip_smoke.device_ms's ``load``).

Inputs, byte bounds and timers are this checkout's chip_smoke.py's. Each
version is also checked against its own plain version; K3 must agree to
1e-5 with finite outputs, or the run stops. --kernels bank or fused times
only K1/K2 or only K3.

--profile: for each ROOT, build its csrc/s2pa_fused.cu alone with
-DS2PA_PROFILE (the kernel's clock marks, S2PA_MARK in
csrc/s2pa_common.cuh; the phase names are the source's `S2PA_PHASES:`
line) and run it on the K3 cases: per case the profiled build's time
(events, L2 flushed), the CTAs and SMs used, the median and 90th
percentile of each phase in cycles, a CTA's life, and the CTAs resident
per SM.

Prints one JSON line per run and a table with the card's nvidia-smi name
and power limit. Needs a CUDA card (and nvcc); imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("bfloat16", "corpus", 3840), ("float32", "corpus", 3840), ("bfloat16", "uniform", 3840),
         ("bfloat16", "zipf", 3840), ("float32", "uniform", 3840), ("float32", "zipf", 3840),
         ("bfloat16", "uniform", 1000))
# (label, B, T, L, layout)
K3_CASES = (("text B=1 Tw=32 L=48", 1, 32, 48, "text"), ("text B=16 Tw=32 L=56", 16, 32, 56, "text"),
            ("synthetic B=16 T=64 L=96", 16, 64, 96, "synthetic"))


def bank_cases(cs, sb, torch):
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
    return out


def k3_inputs(cs, torch, i):
    label, B, T, L, layout = K3_CASES[i]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 100 + i)
    return cs.fused_case(torch.device("cuda"), gen, B, T, L, layout)


def fused_cases(cs, sf, torch):
    out = []
    for i, (label, B, T, L, _) in enumerate(K3_CASES):
        args = k3_inputs(cs, torch, i)
        got = sf.s2pa_fused(*args)
        torch.cuda.synchronize()
        err = torch.stack([(a - b).abs().max() for a, b in zip(got, sf.s2pa_fused_plain(*args))]).max().item()
        if not (err <= 1e-5 and all(bool(torch.isfinite(o).all()) for o in got)):
            raise AssertionError(f"K3 disagrees with its plain version at {label} (max abs err {err})")
        bound_ms, _, n_bytes = cs.fused_bound(B * T, L, cs.FUSED_H, cs.FUSED_P)
        rec = {"case": label, "k3_max_abs_err": err, "bound_ms": bound_ms, "mbytes": n_bytes / 1e6,
               "masked_shares": cs.mask_shares(args[3]),
               "k3_ms": cs.device_ms(lambda: sf.s2pa_fused(*args), cold=True),
               "k3_loaded_ms": cs.device_ms(lambda: sf.s2pa_fused(*args), cold=True, load=50),
               "k3_cold_event_ms": cs.time_ms_cold(lambda: sf.s2pa_fused(*args)),
               "k3_event_ms": cs.time_ms(lambda: sf.s2pa_fused(*args))}
        if hasattr(sf, "fused_kernel_plan"):
            rec["plan"] = sf.fused_kernel_plan(B * T, L, cs.FUSED_H, cs.FUSED_P)
        out.append(rec)
        del args, got
        torch.cuda.empty_cache()
    return out


def worker(root: str, kernels: str) -> dict:
    """One root's measurements, in this process: the inputs, bounds and
    timers are chip_smoke.py's (this checkout's), the kernels the root's."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(root))
    import torch

    from dicttts_tpu_torch.ops import s2pa_bank as sb
    from dicttts_tpu_torch.ops import s2pa_fused as sf

    torch.backends.cuda.matmul.allow_tf32 = False
    return {"root": root, "device": torch.cuda.get_device_name(0),
            "cases": bank_cases(cs, sb, torch) if kernels != "fused" else [],
            "k3_cases": fused_cases(cs, sf, torch) if kernels != "bank" else []}


def profile(root: str) -> dict:
    """K3's clock marks from a -DS2PA_PROFILE build of root's s2pa_fused.cu."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from dicttts_tpu_torch.ops import cuda_build

    src = os.path.join(os.path.abspath(root), "dicttts_tpu_torch", "csrc", "s2pa_fused.cu")
    phases = re.search(r"S2PA_PHASES: (.*)", open(src).read()).group(1).split("|")
    out = tempfile.mkdtemp(prefix="k3_profile_")
    so = os.path.join(out, "libprof.so")
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-DS2PA_PROFILE", "-shared", src, "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.s2pa_fused.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.s2pa_prof_copy.argtypes = [P, ctypes.c_size_t]
    flush = torch.empty(32 << 20, device="cuda")
    res = []
    for i, (label, B, T, L, _) in enumerate(K3_CASES):
        q, k, v, km, pm = k3_inputs(cs, torch, i)
        N, H, Pn = B * T, q.shape[-1], pm.shape[-1]
        ctx, w, pron = torch.empty_like(q), torch.empty((B, T, L), device="cuda"), torch.empty((B, T, Pn),
                                                                                             device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = lib.s2pa_fused(q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), pm.data_ptr(),
                                ctx.data_ptr(), w.data_ptr(), pron.data_ptr(), N, L, H, Pn, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError_t {rc}")

        for _ in range(3):
            call()
        times = []
        for _ in range(10):
            flush.zero_()
            lib.s2pa_prof_clear()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            call()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        buf = np.zeros((100000, 16), np.uint64)
        lib.s2pa_prof_copy(buf.ctypes.data, buf.nbytes)
        own = buf[buf[:, 12] > 0].astype(np.float64)  # CTAs that ran (a start time)
        n_marks = len(phases) + 1
        d = np.diff(own[:, :n_marks], axis=1)
        t0, t1 = own[:, 12].min(), own[:, 13].max()
        grid = np.linspace(t0, t1, 40)[5:35]
        per_sm = [((own[:, 12] <= g) & (own[:, 13] > g) & (own[:, 14] == sm)).sum() for sm in range(132) for g in grid]
        res.append({
            "case": label, "ms": float(np.mean(times[1:])), "ctas": int(len(own)),
            "sms": int(len(np.unique(own[:, 14]))), "span_us": (t1 - t0) / 1e3,
            "phases": {name: [float(np.median(d[:, j])), float(np.percentile(d[:, j], 90))]
                       for j, name in enumerate(phases)},
            "cta_cycles": float(np.median(own[:, n_marks - 1] - own[:, 0])),
            "cta_us": float(np.median(own[:, 13] - own[:, 12]) / 1e3),
            "resident_per_sm": [float(np.mean(per_sm)), int(max(per_sm))]})
    return {"root": root, "device": torch.cuda.get_device_name(0), "profile": res}


def run_worker(root: str, *flags: str) -> dict:
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", *flags, root],
                         capture_output=True, text=True)
    if res.returncode != 0:
        print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
        raise SystemExit(1)
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    print(json.dumps(rec), flush=True)
    return rec


def print_profile(rec: dict) -> None:
    print(f"K3 clock marks, {rec['root']}:")
    for c in rec["profile"]:
        print(f"  {c['case']}: profiled build {c['ms']:.4f} ms (events, L2 flushed), {c['ctas']} CTAs on "
              f"{c['sms']} SMs over {c['span_us']:.2f} us; a CTA's life median {c['cta_cycles']:.0f} cycles, "
              f"{c['cta_us']:.2f} us; CTAs resident per SM mean {c['resident_per_sm'][0]:.2f}, "
              f"max {c['resident_per_sm'][1]}")
        for name, (med, p90) in c["phases"].items():
            print(f"    {name:36s} median {med:7.0f} cycles, p90 {p90:7.0f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", choices=("all", "bank", "fused"), default="all")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        rec = profile(a.roots[0]) if a.profile else worker(a.roots[0], a.kernels)
        print(json.dumps(rec), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if a.profile:
        print(f"on {smi}")
        for root in a.roots:
            print_profile(run_worker(root, "--profile"))
        return 0
    order = []
    for r in range(a.rounds):
        order += a.roots if r % 2 == 0 else a.roots[::-1]
    runs = {root: [] for root in a.roots}
    for root in order:
        runs[root].append(run_worker(root, "--kernels", a.kernels))
    first_run = runs[a.roots[0]][0]
    print(f"K1 / K2 device ms, mean of {a.rounds} runs per root (share of the byte bound); on {smi}")
    for i, first in enumerate(first_run["cases"]):
        print(f"  {first['case']} ({first['distinct_rows']} distinct rows; bounds "
              f"{first['k1_bound_ms']:.4f} / {first['k2_bound_ms']:.4f} ms)")
        for root in a.roots:
            c = [run["cases"][i] for run in runs[root]]
            k1 = sum(x["k1_ms"] for x in c) / len(c)
            k2 = sum(x["k2_ms"] for x in c) / len(c)
            sort = f", sort {sum(x['sort_ms'] for x in c) / len(c):.4f}" if "sort_ms" in c[0] else ""
            print(f"    {root}: K1 {k1:.4f} ({100 * c[0]['k1_bound_ms'] / k1:.1f} %), K2 {k2:.4f} "
                  f"({100 * c[0]['k2_bound_ms'] / k2:.1f} %){sort}; max abs err vs plain "
                  f"{max(x['k1_max_abs_err'] for x in c):.3e} / {max(x['k2_max_abs_err'] for x in c):.3e}")
    print(f"K3 device ms with L2 flushed (torch.profiler), each run's value (share of the byte bound); "
          f"then CUDA events around each call (L2 flushed) and around back-to-back calls; on {smi}")
    for i, first in enumerate(first_run["k3_cases"]):
        print(f"  {first['case']} ({first['mbytes']:.2f} MB, bound {first['bound_ms']:.4f} ms; masked gloss "
              f"tokens {100 * first['masked_shares'][0]:.1f} %, all-masked rows "
              f"{100 * first['masked_shares'][1]:.1f} %)")
        for root in a.roots:
            c = [run["k3_cases"][i] for run in runs[root]]
            ms = " ".join(f"{x['k3_ms']:.4f} ({100 * x['bound_ms'] / x['k3_ms']:.1f} %)" for x in c)
            loaded = " ".join(f"{x['k3_loaded_ms']:.4f}" for x in c)
            cold = " ".join(f"{x['k3_cold_event_ms']:.4f}" for x in c)
            ev = " ".join(f"{x['k3_event_ms']:.4f}" for x in c)
            plan = f"; plan {json.dumps(c[0]['plan'])}" if "plan" in c[0] else ""
            print(f"    {root}: {ms}; with matmuls queued ahead {loaded}; events around each call, L2 flushed "
                  f"{cold}; back to back {ev}; max abs err vs plain {max(x['k3_max_abs_err'] for x in c):.3e}{plan}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
