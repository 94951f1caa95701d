"""Checkpoint save, rotation, best tracking, resume and partial load.

Port of ``dicttts_tpu/utils/checkpoint.py``: files named
``model_ckpt_steps_<N>.ckpt`` in the work dir, newest by step first;
written to a ``.part`` file and moved into place with ``os.replace``, so a
kill mid-write leaves the last good checkpoint; rotation keeps the newest
``keep``; ``is_best`` also writes ``model_ckpt_best.ckpt``, which rotation
never removes. The payload is ``{"global_step": N, "state":
task.state_dict(), **extra}`` (extra: scalars such as ``best_val``) saved
with ``torch.save`` and read back with ``weights_only=True``.
"""

from __future__ import annotations

import glob
import os
import re

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


def save_checkpoint(work_dir: str, step: int, state: dict, keep: int = 3, is_best: bool = False,
                    extra: dict | None = None) -> str:
    """Atomically write the train state; rotate old step checkpoints."""
    os.makedirs(work_dir, exist_ok=True)
    payload = {"global_step": step, "state": state, **(extra or {})}
    path = os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")
    _write(payload, path)
    if is_best:
        _write(payload, os.path.join(work_dir, BEST))
    for old in get_all_ckpts(work_dir)[keep:]:
        os.remove(old)
    return path


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
