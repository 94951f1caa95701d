"""Data parallelism over ``torch.distributed``: one process per card, the
parameters replicated, each global batch split by rows.

Port of ``dicttts_tpu/parallel/mesh.py``. The JAX package puts a 1-D
``data`` mesh over every device, shards each global batch on its row axis
and compiles the step over the whole sharded batch, so every loss is the
global batch's and XLA inserts one gradient all-reduce. Here each rank
runs the step on its rows (``shard_batch``), and the step computes the
same thing by three rules:

- a loss normalizer that counts the batch (frames, words) divides by the
  global count over the world size (``shard_denominator``), so each rank's
  loss is W times its share of the global loss, their mean is the global
  loss, and averaging the gradients (``all_reduce_grads``, one flattened
  collective per parameter set at the update) gives the gradient of the
  global loss. Plain means over equal shards need nothing;
- a nonlinear function of a batch statistic reads the global statistic
  (``global_mean``, ``global_max``: the KL clamp, the discriminator's
  longest sequence);
- the metrics each rank reports, and every decision taken on them (the
  non-finite skip), are the global values (``reduce_metrics``), so all
  ranks take the same branch and meet at the same collectives.

Under NCCL these collectives run inside the trainer's captured CUDA graphs
(``train/graphs.py``); gloo's cannot be captured (``check_graph_capture``).

Batches are padded with zero rows to a multiple of the world size
(``pad_batch_to_devices``, the JAX package's semantics; the providers cut
most batches to that multiple already). A zero row has no tokens and no
frames, so the masked losses skip it; the discriminator's LSGAN terms,
plain means over rows in the JAX package, skip it by its zero length
(``train/losses.row_mean``), so a padded step equals one process's step
on the unpadded batch.

Each function is the identity when no process group exists, so
single-process paths are untouched; in a group of one it runs its
collective (which changes nothing). ``init_distributed`` joins
the group that ``torchrun`` (or ``--multihost``) describes in the
environment; a failed join raises, and nothing drops to one process or to
the CPU.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("dicttts_tpu_torch.mesh")

DEFAULT_TIMEOUT_S = 600.0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_chief() -> bool:
    """Rank 0 writes checkpoints, logs and test outputs."""
    return rank() == 0


def init_distributed(device: str = "cuda", *, multihost: bool = False, init_method: str | None = None,
                     world: int | None = None, rank_: int | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device.

    The group is the one ``torchrun`` describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); with
    ``multihost`` the JAX package's ``DICTTTS_COORDINATOR`` (host:port),
    ``DICTTTS_NUM_PROCESSES`` and ``DICTTTS_PROCESS_ID`` take their place
    where set; ``init_method``, ``world`` and ``rank_`` give it directly.
    ``device`` cuda means ``cuda:LOCAL_RANK`` with NCCL, cpu means gloo.
    Collectives that wait longer than ``timeout_s`` raise."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"data parallelism runs on cuda or cpu, not {device!r}")
    if multihost and init_method is None and os.environ.get("DICTTTS_COORDINATOR"):
        init_method = f"tcp://{os.environ['DICTTTS_COORDINATOR']}"
        world = int(os.environ["DICTTTS_NUM_PROCESSES"])
        rank_ = int(os.environ["DICTTTS_PROCESS_ID"])
    if init_method is None:
        init_method = "env://"
    kw = {}
    if world is not None:
        kw = dict(world_size=world, rank=rank_)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA card is available")
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} CUDA cards")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        # device_id binds the communicator now: a failing NCCL init raises here
        dist.init_process_group("nccl", init_method=init_method, device_id=dev,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=init_method,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
    log.info("data parallel: rank %d of %d on %s (%s)", rank(), world_size(), dev, dist.get_backend())
    return dev


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective on ``t`` runs: NCCL takes CUDA tensors only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _rows(x) -> int | None:
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return int(x.shape[0]) if x.ndim else None
    if isinstance(x, list):
        return len(x)
    return None


def shard_batch(batch: dict, world: int | None = None, index: int | None = None) -> dict:
    """This rank's rows of a global batch: rows [r n / W, (r + 1) n / W)
    of every array, tensor and list (``_meta``); 0-d entries and others are
    kept whole. The row count must divide by W."""
    world = world_size() if world is None else world
    index = rank() if index is None else index
    if world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = _rows(v)
        if n is None:
            out[k] = v
            continue
        if n % world:
            raise ValueError(f"batch entry {k!r} has {n} rows, not a multiple of the world size {world} "
                             "(pad_batch_to_devices first)")
        step = n // world
        out[k] = v[index * step:(index + 1) * step]
    return out


def pad_batch_to_devices(batch: dict, n_devices: int) -> dict:
    """Right-pad every host array's row axis to a multiple of ``n_devices``
    with zeros, as the JAX package does: zero rows carry no tokens and no
    mel frames, so the loss masks ignore them. 0-d entries and non-arrays
    are kept as they are."""
    def pad(x):
        if isinstance(x, np.ndarray) and x.ndim:
            rem = (-x.shape[0]) % n_devices
            return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1)) if rem else x
        return x

    return {k: pad(v) for k, v in batch.items()}


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a tensor, detached (loss normalizers and
    statistics pass no gradient)."""
    x = x.detach()
    if not initialized():
        return x
    dev = _comm_device(x)
    buf = x.to(dev, copy=True)
    dist.all_reduce(buf)
    return buf.to(x.device)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of a tensor, detached: of per-rank losses that
    are W times their shares (``shard_denominator``), the global loss."""
    if not initialized():
        return x.detach()
    return global_sum(x) / world_size()


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The largest value over ranks of a tensor, detached."""
    x = x.detach()
    if not initialized():
        return x
    buf = x.to(_comm_device(x), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)
    return buf.to(x.device)


def shard_denominator(count: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """The denominator of a masked average over a shard: the global
    batch's count (at least ``floor``) over the world size. A rank's loss
    over it is W times its share of the global masked average. In one
    process: max(count, floor)."""
    if not initialized():
        return torch.clamp(count, min=floor)
    return torch.clamp(global_sum(count), min=floor) / world_size()


def reduce_metrics(metrics: dict) -> dict:
    """Every metric's mean over ranks, in one collective: of per-rank
    losses the global batch's. All ranks must pass the same keys."""
    if not initialized() or not metrics:
        return metrics
    keys = list(metrics)
    first = next(v for v in metrics.values() if isinstance(v, torch.Tensor))
    stacked = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).to(first.device).reshape(())
                           for k in keys])
    reduced = global_mean(stacked)
    return {k: reduced[i] for i, k in enumerate(keys)}


def _flat_collective(tensors: list, op) -> None:
    """Run ``op(buffer)`` on the tensors flattened into one buffer per
    dtype on the communication device, then copy the result back."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for ts in groups.values():
        dev = _comm_device(ts[0])
        buf = torch.cat([t.detach().reshape(-1).to(dev) for t in ts])
        op(buf)
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(buf[offset:offset + n].view_as(t))
            offset += n


def all_reduce_grads(params) -> None:
    """Average the ``.grad`` of ``params`` over ranks in place: one
    flattened all-reduce for the parameter set. Parameters without a
    gradient count as zero (they get one)."""
    if not initialized():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    world = world_size()

    def op(buf):
        dist.all_reduce(buf)
        buf.div_(world)

    with torch.no_grad():
        _flat_collective([p.grad for p in params], op)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def broadcast_state(tree) -> None:
    """Overwrite every tensor of ``tree`` (a task's ``state_dict()``,
    whose tensors alias the weights and optimizer moments) with rank 0's,
    in place: one broadcast per dtype."""
    if not initialized():
        return
    with torch.no_grad():
        _flat_collective(_tensors(tree), lambda buf: dist.broadcast(buf, src=0))


def check_graph_capture(what: str) -> None:
    """Raise where a step's collectives cannot be captured in a CUDA graph:
    NCCL's can; gloo copies CUDA tensors through the host."""
    if initialized() and dist.get_backend() != "nccl":
        raise ValueError(f"{what} captures the train step in CUDA graphs, but this process group's "
                         f"{dist.get_backend()} backend copies CUDA tensors through the host, which a graph "
                         "cannot capture: use NCCL (one process per card) or steps_per_dispatch=1")


def barrier() -> None:
    if initialized():
        dist.barrier()
