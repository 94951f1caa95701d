"""Background-thread batch prefetch for the trainer's host pipeline.

Port of ``dicttts_tpu/utils/prefetch.py``: one thread reads and collates
batches ahead of the train loop, so the host's collate overlaps the card's
step. numpy copies release the interpreter lock, so the overlap is real.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch_iterator(it: Iterable, depth: int = 8) -> Iterator:
    """Yield from `it`, producing up to `depth` items ahead on a daemon
    thread. Exceptions in the producer re-raise at the consumer's next
    pull. Order is preserved.

    Abandoning the iterator early (the trainer breaks out at max_updates)
    terminates the producer: the consumer generator's ``finally`` sets a
    stop event that every blocking ``put`` polls, so no thread is left
    parked on a full queue holding collated batches.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def _put(item) -> bool:
        """Blocking put that aborts when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # propagate to the consumer
            _put(("__prefetch_error__", e))
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=_produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
                raise item[1]
            yield item
    finally:
        stop.set()
