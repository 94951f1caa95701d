"""f0 DTW prosody evaluation (the reference's scripts/pitch_dtw.py): the
mean DTW distance between generated and ground-truth f0 contours.

Counterpart of ``scripts/pitch_dtw.py``, on ``eval/metrics.f0_dtw``:

    python -m dicttts_tpu_torch.tools.pitch_dtw --gen_dir <dir with <item>.f0.npy> --gt_dir <dir>

Host-only.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from dicttts_tpu_torch.eval.metrics import f0_dtw


def main(argv=None) -> float:
    """Run the command line ``argv``; returns the mean distance."""
    p = argparse.ArgumentParser()
    p.add_argument("--gen_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    args = p.parse_args(argv)
    dists = []
    for gen_fn in sorted(glob.glob(os.path.join(args.gen_dir, "*.f0.npy"))):
        name = os.path.basename(gen_fn)
        gt_fn = os.path.join(args.gt_dir, name)
        if not os.path.exists(gt_fn):
            continue
        d = f0_dtw(np.load(gen_fn), np.load(gt_fn))
        if np.isfinite(d):
            dists.append(d)
            print(f"{name}: {d:.2f}")
    mean = float(np.mean(dists))
    print(f"| mean f0 DTW over {len(dists)} items: {mean:.3f}")
    return mean


if __name__ == "__main__":
    main()
