"""Checkpoint save, rotation, best tracking, resume and partial load.

Port of ``dicttts_tpu/utils/checkpoint.py``: files named
``model_ckpt_steps_<N>.ckpt`` in the work dir, newest by step first;
written to a ``.part`` file and moved into place with ``os.replace``, so a
kill mid-write leaves the last good checkpoint; rotation keeps the newest
``keep``; ``is_best`` also writes ``model_ckpt_best.ckpt``, which rotation
never removes. The payload is ``{"global_step": N, "state":
task.state_dict(), **extra}`` (extra: scalars such as ``best_val``) saved
with ``torch.save`` and read back with ``weights_only=True``.

The trainer writes on a thread beside the next steps (``CheckpointWriter``),
as the JAX trainer does. The optimizers update the weights and moments in
place, so a thread reading ``state_dict()`` while steps run would save a
mix of steps: ``snapshot`` first copies every tensor, bit for bit, in
stream order on its device (the torch form of the JAX trainer's copy
before the next donating dispatch); the thread then brings the copies to
the host, on the card through a side stream after an event of the
snapshot, and writes them. A pending write is joined before the next one,
so rotation stays ordered; a ``.part`` file is never taken for a
checkpoint.
"""

from __future__ import annotations

import glob
import os
import re
import threading
import time

import torch

BEST = "model_ckpt_best.ckpt"


def _ckpt_step(path: str) -> int:
    m = re.search(r"model_ckpt_steps_(\d+)\.ckpt$", os.path.basename(path))
    return int(m.group(1)) if m else -1


def get_all_ckpts(work_dir: str) -> list[str]:
    """All step checkpoints, newest first."""
    paths = glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt"))
    return sorted(paths, key=_ckpt_step, reverse=True)


def get_last_checkpoint(work_dir: str) -> str | None:
    ckpts = get_all_ckpts(work_dir)
    return ckpts[0] if ckpts else None


def _write(payload: dict, path: str) -> None:
    torch.save(payload, path + ".part")
    os.replace(path + ".part", path)


def checkpoint_path(work_dir: str, step: int) -> str:
    return os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")


def save_checkpoint(work_dir: str, step: int, state: dict, keep: int = 3, is_best: bool = False,
                    extra: dict | None = None) -> str:
    """Atomically write the train state; rotate old step checkpoints."""
    os.makedirs(work_dir, exist_ok=True)
    payload = {"global_step": step, "state": state, **(extra or {})}
    path = checkpoint_path(work_dir, step)
    _write(payload, path)
    if is_best:
        _write(payload, os.path.join(work_dir, BEST))
    for old in get_all_ckpts(work_dir)[keep:]:
        os.remove(old)
    return path


def map_tensors(tree, fn):
    """``tree`` (nested dicts, lists, tuples) with ``fn`` applied to each
    tensor; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def bit_differences(a, b, prefix: str = "") -> list[str]:
    """The paths (``key.index.``) where two trees differ: in their keys or
    lengths, a tensor's dtype, shape or any bit (float tensors compared as
    integers of their width, so NaNs and signed zeros count), or another
    leaf's value."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{prefix}keys"]
        return [d for k in a for d in bit_differences(a[k], b[k], f"{prefix}{k}.")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{prefix}len"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in bit_differences(x, y, f"{prefix}{i}.")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
            return [prefix]
        if a.is_floating_point():
            ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            a, b = a.contiguous().view(ints), b.contiguous().view(ints)
        return [] if torch.equal(a, b) else [prefix]
    return [] if a == b else [prefix]


def snapshot(tree):
    """A bit-exact copy of every tensor of ``tree`` (nested dicts, lists,
    tuples; other leaves kept), detached, each queued on its device's
    current stream after the work already there."""
    return map_tensors(tree, lambda t: t.detach().clone())


def _to_host(tree, stream):
    """``tree``'s tensors on the CPU; card tensors copied on ``stream`` into
    pinned memory, waited for before returning."""
    with torch.cuda.stream(stream):
        out = map_tensors(tree, lambda t: t.to("cpu", non_blocking=True) if t.is_cuda else t)
    stream.synchronize()
    return out


class CheckpointWriter:
    """``save_checkpoint`` of a snapshot on one background thread at a time.
    ``start`` joins the pending write first; ``join`` waits for it and
    raises its error, if it failed."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def start(self, work_dir: str, step: int, state, keep: int = 3, is_best: bool = False,
              extra: dict | None = None) -> dict:
        """Write ``state`` (a ``snapshot``) as step ``step``'s checkpoint on a
        thread. Returns the write's record: its step, the path the file will
        have, and ``write_s``, the seconds the thread took (the host copy,
        ``torch.save``, rotation), set when it ends."""
        self.join()
        device = next((t.device for t in _tensor_leaves(state) if t.is_cuda), None)
        stream = event = None
        if device is not None:
            stream = torch.cuda.Stream(device)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        record = {"step": step, "path": checkpoint_path(work_dir, step), "write_s": None}

        def write():
            t0 = time.perf_counter()
            try:
                if event is not None:
                    with torch.cuda.device(device):
                        stream.wait_event(event)
                        host = _to_host(state, stream)
                else:
                    host = state
                save_checkpoint(work_dir, step, host, keep=keep, is_best=is_best, extra=extra)
            except BaseException as e:  # raised again by join()
                self._error = e
            record["write_s"] = time.perf_counter() - t0

        self._thread = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        return record

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("the background checkpoint write failed") from error


def _tensor_leaves(tree) -> list:
    out = []
    map_tensors(tree, out.append)
    return out


def _load(path: str, map_location=None) -> dict:
    return torch.load(path, map_location=map_location, weights_only=True, mmap=True)


def load_checkpoint(path: str, map_location=None) -> tuple[int, dict]:
    """(global_step, state) of a checkpoint written by ``save_checkpoint``."""
    payload = _load(path, map_location)
    return int(payload["global_step"]), payload["state"]


def read_extras(path: str) -> dict:
    """The scalars saved beside the state (e.g. ``best_val``)."""
    payload = _load(path, "cpu")
    return {k: v for k, v in payload.items() if k not in ("global_step", "state")}


def load_partial(path: str, target: dict, subtree: str | None = "params_g") -> tuple[dict, list[str]]:
    """Shape-tolerant load for fine-tuning: ``target`` is a module's
    ``state_dict()``; each entry takes the checkpoint's tensor of the same
    name and shape, and keeps its own value otherwise. ``subtree`` selects
    the parameters inside the saved state (None: the state itself).
    Returns (the new state dict, the names that kept their value)."""
    src = _load(path, "cpu")["state"]
    if subtree:
        src = src[subtree]
    out, skipped = {}, []
    for name, value in target.items():
        saved = src.get(name)
        if saved is not None and saved.shape == value.shape:
            out[name] = saved.to(device=value.device, dtype=value.dtype)
        else:
            out[name] = value
            skipped.append(name)
    return out, skipped
