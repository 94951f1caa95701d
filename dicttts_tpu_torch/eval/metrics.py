"""Objective metrics: f0 DTW distance, duration errors, stage timers, RTF.

Port of ``dicttts_tpu/eval/metrics.py`` (host-only numpy): DTW distance
between generated and reference f0 contours (upstream
scripts/pitch_dtw.py), word and sentence duration absolute errors
(upstream tasks/tts/ps_adv.py:96-122), the named cumulative ``Timer`` of
``profile_infer`` and ``profile_rtf``.

On the card a stage's work is asynchronous: a ``Timer`` around it must end
with the stage's device-to-host copy (or pass ``sync_fn``) so that it
times the card and not the launches.
"""

from __future__ import annotations

import time

import numpy as np


def dtw_distance(x: np.ndarray, y: np.ndarray) -> float:
    """Classic O(len(x)*len(y)) DTW with absolute-difference cost."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    n, m = len(x), len(y)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    cost = np.abs(x[:, None] - y[None, :])
    for i in range(1, n + 1):
        D[i, 1 : m + 1] = cost[i - 1]
        for j in range(1, m + 1):
            D[i, j] += min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[n, m])


def f0_dtw(f0_gen: np.ndarray, f0_ref: np.ndarray, voiced_only: bool = True) -> float:
    if voiced_only:
        f0_gen = f0_gen[f0_gen > 0]
        f0_ref = f0_ref[f0_ref > 0]
    if len(f0_gen) == 0 or len(f0_ref) == 0:
        return float("inf")
    return dtw_distance(f0_gen, f0_ref) / max(len(f0_ref), 1)


def duration_errors(dur_pred: np.ndarray, dur_gt: np.ndarray, mask: np.ndarray) -> dict:
    """Word-level and sentence-level absolute duration errors (frames)."""
    mask = mask.astype(bool)
    wdur_abs = np.abs(dur_pred - dur_gt)[mask].mean() if mask.any() else 0.0
    sdur_abs = np.abs(dur_pred[mask].sum() - dur_gt[mask].sum())
    return {"wdur_abs": float(wdur_abs), "sdur_abs": float(sdur_abs)}


class Timer:
    """Named cumulative timer (reference utils.Timer) with device sync."""

    totals: dict[str, float] = {}

    def __init__(self, name: str, enable: bool = True, sync_fn=None):
        self.name = name
        self.enable = enable
        self.sync_fn = sync_fn

    def __enter__(self):
        if self.enable:
            if self.sync_fn:
                self.sync_fn()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enable:
            if self.sync_fn:
                self.sync_fn()
            Timer.totals[self.name] = Timer.totals.get(self.name, 0.0) + time.perf_counter() - self.t0


def profile_rtf(fn, audio_secs: float, n_iters: int = 10, warmup: int = 1) -> dict:
    """Run fn() n_iters times; returns RTF stats. fn must block until the
    device result is ready (a host copy or torch.cuda.synchronize inside)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {
        "rtf_mean": float(times.mean() / audio_secs),
        "rtf_p50": float(np.median(times) / audio_secs),
        "latency_p50_ms": float(np.median(times) * 1000),
        "latency_p90_ms": float(np.percentile(times, 90) * 1000),
    }
