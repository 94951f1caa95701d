"""Ordered multiprocess fan-out for the offline pipeline's host work.

Port of ``dicttts_tpu/utils/multiprocess.py``'s ``MultiprocessManager``:
a pool of N worker processes started by ``spawn`` (a fresh interpreter, so
no CUDA state is inherited) that yields its jobs' results in submission
order; an exception in a worker gives that job None, its traceback logged.
The binarizer gives the workers text work only; they never touch the card.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import traceback

log = logging.getLogger("dicttts_tpu_torch.mp")


def _worker(fn, item):
    try:
        return fn(*item) if isinstance(item, tuple) else fn(item)
    except Exception:
        log.warning("worker error:\n%s", traceback.format_exc())
        return None


def _star(job):
    fn, item = job
    return _worker(fn, item)


class MultiprocessManager:
    """Persistent worker pool with queued jobs and ordered result collection
    (upstream MultiprocessManager semantics)."""

    def __init__(self, num_workers: int | None = None):
        self.num_workers = num_workers if num_workers is not None else max(mp.cpu_count() - 1, 1)
        ctx = mp.get_context("spawn")
        self.pool = ctx.Pool(self.num_workers)
        self._results = []

    def add_job(self, fn, args: tuple):
        self._results.append(self.pool.apply_async(_star, ((fn, args),)))

    def get_results(self):
        for r in self._results:
            yield r.get()
        self._results = []

    def close(self):
        self.pool.close()
        self.pool.join()
