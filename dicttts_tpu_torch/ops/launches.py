"""Launch counts of the hand-written kernels' wrappers.

A wrapper calls ``count_launch(wrapper)`` where it launches its kernel,
and nowhere else: one more in ``wrapper.launches``. While a CUDA graph is
being captured the launch is a node of that graph instead: it adds one to
``wrapper.captured``, and the wrapper joins ``CAPTURED``, the wrappers a
capture has seen. A graph runner (``train/graphs.py``) reads their
``captured`` before and after a capture, and adds a graph's nodes to
``launches`` at each replay.
"""

from __future__ import annotations

import torch

CAPTURED: set = set()


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel, or, under a CUDA graph's
    capture, one node of the graph."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
        CAPTURED.add(wrapper)
    else:
        wrapper.launches += 1
