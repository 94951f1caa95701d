"""Checkpoint save, rotation and resume.

Port of ``dicttts_tpu/utils/checkpoint.py``: files named
``model_ckpt_steps_<N>.ckpt`` in the work dir, newest by step first;
written to a ``.part`` file and moved into place with ``os.replace``, so a
kill mid-write leaves the last good checkpoint; rotation keeps the newest
``keep``. The payload is ``{"global_step": N, "state": task.state_dict()}``
saved with ``torch.save`` and read back with ``weights_only=True``.
"""

from __future__ import annotations

import glob
import os
import re

import torch


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


def save_checkpoint(work_dir: str, step: int, state: dict, keep: int = 3) -> str:
    """Atomically write the train state; rotate old step checkpoints."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")
    torch.save({"global_step": step, "state": state}, path + ".part")
    os.replace(path + ".part", path)
    for old in get_all_ckpts(work_dir)[keep:]:
        os.remove(old)
    return path


def load_checkpoint(path: str, map_location=None) -> tuple[int, dict]:
    """(global_step, state) of a checkpoint written by ``save_checkpoint``."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return int(payload["global_step"]), payload["state"]
