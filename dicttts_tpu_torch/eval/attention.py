"""Attention-health diagnostics of encoder-decoder alignments (numpy).

Port of ``dicttts_tpu/eval/attention.py``: focus rate (the mean over
output steps of the largest input weight), phone coverage (the share of
inputs whose largest received weight passes a threshold) and diagonal
focus rate (the attention mass within a band around the monotonic
diagonal).
"""

from __future__ import annotations

import numpy as np


def focus_rate(attn: np.ndarray, out_mask: np.ndarray | None = None) -> float:
    """attn [T_out, T_in]: mean over output steps of the largest weight."""
    peak = attn.max(-1)
    if out_mask is not None:
        peak = peak[out_mask.astype(bool)]
    return float(peak.mean()) if peak.size else 0.0


def phone_coverage_rate(attn: np.ndarray, in_mask: np.ndarray | None = None,
                        threshold: float = 0.1) -> float:
    """Share of input tokens whose largest received weight > threshold."""
    received = attn.max(0)
    if in_mask is not None:
        received = received[in_mask.astype(bool)]
    return float((received > threshold).mean()) if received.size else 0.0


def diagonal_focus_rate(attn: np.ndarray, band_width_ratio: float = 0.2) -> float:
    """Attention mass within ``band_width_ratio`` of the diagonal, over all."""
    T_out, T_in = attn.shape
    rows = np.arange(T_out)[:, None] / max(T_out - 1, 1)
    cols = np.arange(T_in)[None, :] / max(T_in - 1, 1)
    band = np.abs(rows - cols) <= band_width_ratio
    total = attn.sum()
    return float((attn * band).sum() / total) if total > 0 else 0.0


def attention_metrics(attn: np.ndarray, in_len: int | None = None,
                      out_len: int | None = None) -> dict:
    if out_len:
        attn = attn[:out_len]
    if in_len:
        attn = attn[:, :in_len]
    return {"fr": focus_rate(attn), "pcr": phone_coverage_rate(attn),
            "dfr": diagonal_focus_rate(attn)}
