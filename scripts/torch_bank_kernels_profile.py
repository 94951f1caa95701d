"""Where the time of K1 (csrc/s2pa_bank_fwd.cu) goes, phase by phase, on
the card.

    python3 scripts/torch_bank_kernels_profile.py [--out DIR]

Compiles s2pa_bank_fwd.cu with -DS2PA_PROFILE into DIR (default: a
temporary directory): the kernel's own marks (S2PA_MARK in
csrc/s2pa_common.cuh, nothing in the port's builds) then record, in
thread 0 of every CTA that owns a chunk of slots, clock64() at the phase
boundaries of its first slot, and %globaltimer at its start and end and
its SM. It runs that build at the training geometry (bank 8000 x 96 x 768,
N = 3840) in bf16 and f32 with chip_smoke.py's corpus-like, uniform and
Zipf word ids, and at the serving geometry (bf16, N = 1000), on
chip_smoke.py's inputs (bank_case), and prints for each case the kernel's
time, the median and 90th percentile of each phase in cycles, the CTAs
resident per SM, and the most clusters the card holds at once
(cudaOccupancyMaxActiveClusters). Needs a CUDA card and nvcc; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ("start: find chunk, issue copies", "phase 1 (incl. the copy)", "warp statistics", "cluster sync 1",
          "combine statistics", "weights out", "column pass (push)", "cluster sync 2", "reduce and store",
          "later slots, exit")


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from dicttts_tpu_torch.ops import cuda_build
    from dicttts_tpu_torch.ops.s2pa_bank import bank_kernel_plan, slot_order

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = a.out or tempfile.mkdtemp(prefix="bank_profile_")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libprof.so")
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-DS2PA_PROFILE", "-shared",
                    str(cuda_build.CSRC_DIR / "s2pa_bank_fwd.cu"), "-o", so], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.s2pa_bank_fwd.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.s2pa_prof_copy.argtypes = [P, ctypes.c_size_t]
    lib.s2pa_prof_max_clusters.argtypes = [I, I, I]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"K1 phase profile on {smi}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    L, E = cs.BANK_L, cs.BANK_E
    flush = torch.empty(32 << 20, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        C, smem = bank_kernel_plan(L, E, dtype)
        bf = int(dtype == torch.bfloat16)
        print(f"{dtype}: C={C}, K2's {smem} bytes of shared memory a CTA; K1's clusters at once: "
              f"{lib.s2pa_prof_max_clusters(C, smem, bf)} at that size")
        cases = (("corpus", 3840), ("uniform", 3840), ("zipf", 3840)) + ((("uniform", 1000),) if bf else ())
        for kind, N in cases:
            (bank, wt, qe, km, mask), _, _ = cs.bank_case(dev, gen, dtype, N, kind)
            ids, order = slot_order(wt)
            ctx, w = torch.empty_like(qe), torch.empty((N, L), device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                rc = lib.s2pa_bank_fwd(bank.data_ptr(), ids.data_ptr(), order.data_ptr(), qe.data_ptr(),
                                       km.data_ptr(), mask.data_ptr(), ctx.data_ptr(), w.data_ptr(), N, L, E, bf,
                                       stream)
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
            buf = np.zeros((N * C, 16), np.uint64)
            lib.s2pa_prof_copy(buf.ctypes.data, buf.nbytes)
            own = buf[buf[:, 15] > 0].astype(np.float64)
            d = np.diff(own[:, :11], axis=1)
            print(f"  {kind} N={N}: kernel {np.mean(times[1:]):.4f} ms (profiled build), {len(own)} CTAs "
                  f"own chunks, {own[:, 15].mean():.2f} slots each")
            for i, name in enumerate(PHASES):
                print(f"    {name:34s} median {np.median(d[:, i]):7.0f} cycles, p90 {np.percentile(d[:, i], 90):7.0f}")
            tot = own[:, 10] - own[:, 0]
            t0, t1 = own[:, 12].min(), own[:, 13].max()
            grid = np.linspace(t0, t1, 200)[50:150:5]
            per_sm = [((own[:, 12] <= g) & (own[:, 13] > g) & (own[:, 14] == sm)).sum()
                      for sm in range(132) for g in grid]
            print(f"    a CTA's life: median {np.median(tot):.0f} cycles, "
                  f"{np.median(own[:, 13] - own[:, 12]) / 1e3:.2f} us; "
                  f"CTAs resident per SM: mean {np.mean(per_sm):.2f}, max {max(per_sm)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
