"""Matplotlib figures for TensorBoard validation logging.

The port's own copy of ``dicttts_tpu/utils/plot.py``: the mel comparison,
duration bars, f0 curves, alignment heatmaps and the per-gloss
dictionary-attention figure. Every function returns a Figure (Agg
backend; the trainer adds it to TensorBoard). matplotlib is imported at
the first figure, so a machine without it imports this module."""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def spec_figure(mel: np.ndarray, mel_gt: np.ndarray | None = None, vmin=-6, vmax=1.5, title=""):
    plt = _plt()
    fig = plt.figure(figsize=(12, 6))
    mel = np.asarray(mel)
    if mel_gt is not None:
        mel_gt = np.asarray(mel_gt)
        # side-by-side in frequency; pad the shorter one in time
        T = max(mel.shape[0], mel_gt.shape[0])
        mel = np.pad(mel, ((0, T - mel.shape[0]), (0, 0)), constant_values=vmin)
        mel_gt = np.pad(mel_gt, ((0, T - mel_gt.shape[0]), (0, 0)), constant_values=vmin)
        mel = np.concatenate([mel_gt, mel], axis=-1)
    plt.pcolor(mel.T, vmin=vmin, vmax=vmax)
    plt.colorbar()
    plt.title(title)
    return fig


def dur_figure(dur_gt: np.ndarray, dur_pred: np.ndarray, tokens: list[str] | None = None):
    plt = _plt()
    fig = plt.figure(figsize=(12, 3))
    idx = np.arange(len(dur_gt))
    plt.bar(idx - 0.2, dur_gt, 0.4, label="gt")
    plt.bar(idx + 0.2, dur_pred, 0.4, label="pred")
    if tokens:
        plt.xticks(idx, tokens, fontsize=6)
    plt.legend()
    return fig


def f0_figure(f0_gt: np.ndarray, f0_pred: np.ndarray | None = None):
    plt = _plt()
    fig = plt.figure(figsize=(12, 3))
    plt.plot(np.asarray(f0_gt), label="gt")
    if f0_pred is not None:
        plt.plot(np.asarray(f0_pred), label="pred")
    plt.legend()
    return fig


def attn_figure(attn: np.ndarray, title=""):
    plt = _plt()
    fig = plt.figure(figsize=(8, 8))
    plt.imshow(np.asarray(attn).T, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar()
    plt.title(title)
    return fig


def dict_attn_figure(weights: np.ndarray, gloss_tokens: list[str], char: str = ""):
    """Per-character attention over its gloss tokens (reference
    plot_dict_attn): bar chart of weights labeled by gloss token."""
    plt = _plt()
    fig = plt.figure(figsize=(10, 3))
    w = np.asarray(weights)[: len(gloss_tokens)]
    plt.bar(np.arange(len(w)), w)
    plt.xticks(np.arange(len(w)), gloss_tokens[: len(w)], fontsize=6, rotation=90)
    plt.title(char)
    plt.tight_layout()
    return fig
