#!/usr/bin/env python3
"""Time the train step's two T/4 convolutions, forward and backward, by batch size.

    python3 scripts/torch_conv_batch_sweep.py [--sizes 36,40,44,46,48,49,52,56,60] [--frames 512,768]

The recipe's batches on the corpus take ~110 ms a step at up to 44
sentences and 800-1100 ms at 49-60 sentences of 512 frames (chip_smoke.py
phase 8). Phase 7's profile puts the slow step in the backward of two
Conv1d shapes at T/4 frames, the FVAE posterior encoder's WaveNet conv
(192 -> 384, kernel 5) and the prior flow's (64 -> 128, kernel 3). This
script times each alone (f32, TF32 off, cuDNN's default heuristics, as
the port trains) for each batch size and mel bucket, with CUDA events
over 10 calls after 3 warm-up, and names the kernels that take the most
device time in one backward under torch.profiler, so the algorithm
cuDNN picks at each size shows. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

CONVS = {"fvae_wn_k5": (192, 384, 5), "flow_wn_k3": (64, 128, 3)}


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def top_kernels(fn, n: int = 2) -> str:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    return "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms" for e in events[:n])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sizes", default="36,40,44,46,48,49,52,56,60")
    parser.add_argument("--frames", default="512,768")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv_batch_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for frames in (int(f) for f in args.frames.split(",")):
        for name, (c_in, c_out, k) in CONVS.items():
            conv = torch.nn.Conv1d(c_in, c_out, k, padding=k // 2).cuda()
            for b in (int(s) for s in args.sizes.split(",")):
                x = torch.randn((b, c_in, frames // 4), generator=gen, device="cuda", requires_grad=True)
                g = torch.randn((b, c_out, frames // 4), generator=gen, device="cuda")
                fwd = time_ms(lambda: conv(x))
                y = conv(x)

                def bwd():
                    torch.autograd.grad(y, (x, conv.weight, conv.bias), g, retain_graph=True)

                print(f"{name} T/4={frames // 4} B={b}: forward {fwd:.3f} ms, backward {time_ms(bwd):.3f} ms "
                      f"[{top_kernels(bwd)}]; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
