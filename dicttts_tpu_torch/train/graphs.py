"""CUDA-graph replays of a task's train step: the trainer's K steps in one
host dispatch.

Port of the JAX trainer's ``steps_per_dispatch`` dispatch
(``dicttts_tpu/train/trainer.py``, ``multi_step_fn``: a ``lax.scan`` of K
same-shape steps, compiled once per shape). Here a step is captured into a
``torch.cuda.CUDAGraph`` once per key, and each step of a group replays
it: the host launches one graph a step instead of some thousands of
kernels, and reads nothing from the card until the group ends.

Every task of ``train/tasks`` declares its step capture-safe
(``capture_safe``; a task that cannot be captured says why in
``capture_reason``, and the trainer runs it eagerly and reports that).
A key is the batch's entries with their shapes and dtypes and the task's
``step_key()``: the step's gates, known on the host ahead of the step and
named by ``step_key_names`` (the adversarial tasks' adv_on and disc_on,
the two-stage PortaSpeech's post_on, HiFi-GAN's disc_on; FastSpeech2 has
none). A key's first step runs eagerly: it is a real step and the warm-up
that allocates every state the captured step reads (cuDNN's and cuBLAS's
handles and workspaces, cuFFT's plans, the loss's blur matrices, the mel
filterbank). The optimizers' moments and counts and the accumulators'
means and counts exist before any step (the tasks allocate them when they
build their state, and the runner calls every optimizer's
``init_state``). Its second step is captured and then replayed, and so
is every later one. The warm-up and the capture run on one side stream; replays
run on the current stream, after the batch's copy from pinned host memory
into the graph's static input buffers.

- **Memory.** Every graph of a runner allocates from one private pool, so
  a graph reuses what the earlier captures freed (cuDNN's FFT workspace
  at 49-60 sentences in f32 takes ~38 GiB). Everything a graph reads
  across replays (weights, moments, counts, the bank, the frame cache,
  the static inputs) is allocated outside the pool. A capture can use
  only memory the caching allocator gives back to the card, and cuDNN
  takes another algorithm where it finds no room for a workspace, so the
  runner keeps the card's memory free of pinned pieces: every optimizer's
  state is allocated when the runner starts, before any step's transient
  blocks exist to be split by it, and before each capture the gradients
  are dropped and the allocator's cache emptied. An eager warm-up cannot
  use the pool's free memory, so before one the runner drops the graphs
  whose keys can no longer occur (``task.step_key_live``: for the
  adversarial tasks, the generator-only steps once the discriminator has
  started; for the two-stage PortaSpeech, the first stage's steps once
  the Glow trains), and with them their share of the pool.
- **Randomness.** A captured step draws from one generator registered
  with every graph and seeded before each replay with the step's seed, so
  a replay draws what ``step_generator(step)`` draws eagerly.
- **Python side effects.** The capture runs the step's Python once and
  launches nothing; ``task.step`` is put back after it, and each replay
  advances it by one. A kernel's wrapper counts a launch under capture
  as a node of the graph (``ops/launches.py``); each replay adds the
  graph's nodes to the wrappers' ``launches``.

A failed capture raises; nothing falls back to eager steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from dicttts_tpu_torch.ops.launches import CAPTURED
from dicttts_tpu_torch.train.optim import MaskedAdamW


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: dict  # the static device buffers the graph reads its batch from
    outputs: dict  # the step's metrics, overwritten by each replay
    nodes: tuple  # (wrapper, its kernel's nodes in the graph), for the wrappers with any
    replays: int = 0


class StepGraphs:
    """The captured train steps of ``task`` on ``device`` (CUDA): ``step``
    runs one train step, eagerly or by replay."""

    def __init__(self, task, device: torch.device):
        self.task = task
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.generator = torch.Generator(device=self.device)
        self.seen: set = set()  # keys that ran their eager warm-up
        self.graphs: dict = {}
        self.capture_s: dict = {}  # key -> seconds its capture took
        self.dropped: list = []  # the reports of graphs dropped as dead
        self.eager_steps = 0
        self.memory: dict = {}  # key -> (free, reserved) GiB on the card before its capture
        for opt in self._optimizers():
            if isinstance(opt, MaskedAdamW):
                opt.init_state()
        self.last = ""  # how the last step ran: "eager", "captured" (then replayed) or "replayed"

    def key(self, batch: dict) -> tuple:
        shapes = tuple((k, tuple(v.shape), str(v.dtype)) for k, v in sorted(batch.items()))
        return shapes, self.task.step_key()

    def step(self, batch: dict, seed: int) -> dict:
        """One train step on ``batch`` (host tensors, pinned) with the
        randomness of ``seed``; returns its metrics (device scalars)."""
        key = self.key(batch)
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self.seen:
                self.seen.add(key)
                self._drop_dead()
                self.last = "eager"
                return self._eager(batch, seed)
            entry = self.graphs[key] = self._capture(key, batch)
            self.last = "captured"
        else:
            self.last = "replayed"
        for k, v in batch.items():
            entry.inputs[k].copy_(v, non_blocking=True)
        self.generator.manual_seed(seed)
        entry.graph.replay()
        entry.replays += 1
        self.task.step += 1
        for wrapper, n in entry.nodes:
            wrapper.launches += n
        return entry.outputs

    def _drop_dead(self) -> None:
        """Drop the graphs whose keys the task says cannot occur again, and
        return their memory."""
        live = getattr(self.task, "step_key_live", None)
        dead = [k for k in self.graphs if not live(k[1])] if live else []
        if not dead:
            return
        for k in dead:
            self.dropped.append(self._entry_report(k, self.graphs.pop(k)))
        self._free()

    def _optimizers(self) -> list:
        return [v for v in vars(self.task).values() if isinstance(v, torch.optim.Optimizer)]

    def _free(self) -> None:
        """The task's gradients (a step's last live tensors) to None, then
        the allocator's cache emptied: a dropped graph's pool and an eager
        step's freed blocks go back to the card."""
        for opt in self._optimizers():
            opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()

    def _eager(self, batch: dict, seed: int) -> dict:
        """The key's warm-up: a real step, on the capture's stream."""
        self.eager_steps += 1
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self.task.train_step(self.task.to_device(batch),
                                       torch.Generator(device=self.device).manual_seed(seed))
        current.wait_stream(self.stream)
        return out

    def _capture(self, key, batch: dict) -> _Graph:
        task = self.task
        inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device) for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        step = task.step
        before = {w: w.captured for w in CAPTURED}
        self._free()
        self.memory[key] = (torch.cuda.mem_get_info(self.device)[0] / 2 ** 30,
                            torch.cuda.memory_reserved(self.device) / 2 ** 30)
        t0 = time.perf_counter()
        # thread_local: the prefetch thread pins batches and the checkpoint
        # thread copies and waits on its own stream while a step is captured
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
            outputs = task.train_step(task.to_device(inputs), self.generator)
        self.capture_s[key] = time.perf_counter() - t0
        task.step = step
        nodes = tuple((w, w.captured - before.get(w, 0)) for w in CAPTURED if w.captured > before.get(w, 0))
        return _Graph(graph, inputs, outputs, nodes)

    def _entry_report(self, key, entry: _Graph) -> dict:
        shapes, gates = key
        return {"key": [{k: list(shape) for k, shape, _ in shapes},
                        {n: bool(g) for n, g in zip(self.task.step_key_names, gates, strict=True)}],
                "capture_s": self.capture_s[key], "replays": entry.replays,
                "nodes": {w.__name__: n for w, n in entry.nodes},
                "free_gib": self.memory[key][0], "reserved_gib": self.memory[key][1]}

    def report(self) -> dict:
        """Each graph's key (the batch's shapes, the gates), capture seconds,
        replays and kernel nodes, the dropped ones included; the eager
        steps."""
        graphs = self.dropped + [self._entry_report(k, g) for k, g in self.graphs.items()]
        return {"graphs": graphs, "replays": sum(g["replays"] for g in graphs),
                "capture_s": sum(self.capture_s.values()), "eager_steps": self.eager_steps}

    def release(self) -> None:
        """Drop every graph and return the pool's memory."""
        self.dropped += [self._entry_report(k, g) for k, g in self.graphs.items()]
        self.graphs.clear()
        self._free()
