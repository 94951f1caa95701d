"""Data-parallel workers and inputs for the port's two-rank CPU tests.

Spawned ranks import only torch and the port (no JAX). ``spawn`` starts
W ranks on the CPU with gloo over a FileStore, one intra-op thread each and
a 60 s collective timeout (a hang fails instead of blocking), runs
``fn(*args)`` on every rank and returns each rank's result. The scenario
functions run as well in one process (no group), which gives the
reference they are held to.
"""

from __future__ import annotations

import itertools
import os
import traceback

import numpy as np
import torch

from dicttts_tpu_torch.parallel import mesh
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task
from dicttts_tpu_torch.train.tasks.hifigan import HifiGanTask
from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask

TIMEOUT_S = 60


def spawn(tmp_path, fn, *args, world: int = 2, group: bool = True) -> list:
    """``fn(*args)`` on ``world`` spawned ranks inside a gloo group, or
    with ``group`` False ``fn(rank, *args)`` with no group (the function
    joins one itself); each rank's result."""
    out = str(tmp_path)
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    torch.multiprocessing.spawn(_entry, args=(world, store, out, fn, args, group), nprocs=world,
                                join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, store: str, out: str, fn, args, group: bool) -> None:
    torch.set_num_threads(1)
    if not group:
        result = fn(rank, *args)
    else:
        mesh.init_distributed("cpu", init_method=f"file://{store}", world=world, rank_=rank,
                              timeout_s=TIMEOUT_S)
        try:
            result = fn(*args)
        finally:
            mesh.dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pinned_draws(task_cls) -> dict:
    """Replacements for ``task_cls``'s ``train_step``, ``val_step`` and
    ``_forward`` under which no draw of a step depends on the ranks. Step
    call i (the same calls, in the same order, on every rank and in one
    process) draws its crop starts from a generator seeded by i, and its
    posterior noise from numpy's RandomState(i) for the global batch's
    rows, cut to this rank's: numpy fills row by row, so the real rows
    draw the same noise whether or not zero rows pad the batch. With
    dropout 0, ``run.main`` on W ranks then computes what one process
    computes, up to summation order."""
    calls = itertools.count()
    train, val, forward = task_cls.train_step, task_cls.val_step, task_cls._forward

    def gen():
        return torch.Generator().manual_seed(next(calls))

    def train_step(self, batch, generator=None, **kw):
        return train(self, batch, gen(), **kw)

    def val_step(self, batch, generator=None, eps=None):
        return val(self, batch, gen(), eps)

    def _forward(self, batch, generator=None, eps=None):
        if eps is None:  # the FVAE's posterior noise [B, T / 4, latent] of the global batch
            b, t = batch["mels"].shape[:2]
            eps = np.random.RandomState(generator.initial_seed()).randn(
                b * mesh.world_size(), t // 4, self.cfg["latent_size"]).astype(np.float32)
            eps = torch.from_numpy(local(eps)).to(batch["mels"].device)
        return forward(self, batch, generator, eps)

    return {"train_step": train_step, "val_step": val_step, "_forward": _forward}


def run_main_ranks(rank: int, work: str, ports: list, recipe: str, hparams: list,
                   exp_names: list | None = None, pinned: bool = True) -> dict:
    """``run.main`` on the CPU as one rank of two, with ``pinned_draws``
    (``pinned``; else the trainer's draws, a function of the step): a
    torchrun-style join (MASTER_ADDR/PORT, WORLD_SIZE, RANK, LOCAL_RANK)
    for each command line of ``hparams``, but where it is None ``--infer``
    through ``--multihost``'s DICTTTS_* variables; each under its name in
    ``exp_names`` (default "toy"). Returns, per run, the trainer's step,
    history and groups, validation means, weights' checksum, the
    checkpoints this rank wrote and the test batches it ended with."""
    from dicttts_tpu_torch import run
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask as Task
    from dicttts_tpu_torch.utils import checkpoint as ckpt_mod  # the trainer's writer thread calls it

    for name, fn in (pinned_draws(Task) if pinned else {}).items():
        setattr(Task, name, fn)
    os.chdir(work)
    written, ended = [], []
    save, test_end = ckpt_mod.save_checkpoint, Task.test_end
    ckpt_mod.save_checkpoint = lambda *a, **k: written.append(a[1]) or save(*a, **k)
    Task.test_end = lambda self, outputs: ended.append(len(outputs)) or test_end(self, outputs)
    runs = []
    for i, hp in enumerate(hparams):
        base = ["--config", recipe, "--exp_name", exp_names[i] if exp_names else "toy", "--device", "cpu",
                "--dist_timeout", str(TIMEOUT_S)]
        infer = hp is None
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "DICTTTS_COORDINATOR",
                  "DICTTTS_NUM_PROCESSES", "DICTTTS_PROCESS_ID"):
            os.environ.pop(k, None)
        if infer:
            os.environ.update(DICTTTS_COORDINATOR=f"127.0.0.1:{ports[i]}", DICTTTS_NUM_PROCESSES="2",
                              DICTTTS_PROCESS_ID=str(rank))
            argv = [*base, "--multihost", "--infer"]
        else:
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[i]), WORLD_SIZE="2",
                              RANK=str(rank), LOCAL_RANK=str(rank))
            argv = [*base, "--hparams", hp]
        written.clear()
        ended.clear()
        trainer, task = run.main(argv)
        runs.append({"step": trainer.global_step, "task_step": getattr(task, "step", None),
                     "history": [h["sentences"] for h in trainer.history],
                     "groups": [(h["group"], h["group_size"]) for h in trainer.history],
                     "val": dict(trainer.val_metrics), "best_val": trainer.best_val,
                     "checksum": (float(sum(p.double().sum() for p in task.model.state_dict().values()))
                                  if hasattr(task, "model") else None),
                     "written": list(written), "test_end": list(ended),
                     "initialized_after": mesh.initialized()})
    return {"runs": runs}


def run_scenarios(scenarios: list) -> dict:
    """Each (name, fn, kwargs) in order, results by name; the first that
    raises stops the run (the ranks would otherwise meet at mismatched
    collectives) and leaves its traceback under its name."""
    results = {}
    for name, fn, kw in scenarios:
        try:
            results[name] = fn(**kw)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
            break
    return results


def local(x: np.ndarray) -> np.ndarray:
    """This rank's rows of a global array (the whole of it in one process)."""
    return mesh.shard_batch({"x": x})["x"]


def params(*modules) -> dict:
    return {f"{i}.{n}": p.detach().clone() for i, m in enumerate(modules) for n, p in m.named_parameters()}


def adam_atol(opt, p, top: float) -> np.ndarray:
    """Per element of ``p``: 1e-6, plus the most that a gradient difference
    at the gradient tolerance (1e-3 |g| + 1e-6 top, |g| read as
    sqrt(v_hat)) moves the last Adam step of lr, at most 2 lr
    (tests/test_torch_accumulate.py)."""
    st, group = opt.state[p], opt.param_groups[0]
    lr, eps, b2 = float(group["lr"]), group["eps"], group["betas"][1]  # the lr is a device scalar
    g = (st["exp_avg_sq"] / (1 - b2 ** float(st["step"]))).sqrt().numpy()
    return 1e-6 + np.minimum(lr * (1e-3 * g + 1e-6 * top) / (g + eps), 2 * lr)


def update_atol(task, modules) -> dict:
    """``adam_atol`` of the update just taken, for every parameter of
    ``modules`` (keyed as ``params`` keys them), by whichever of the task's
    optimizers holds it; 1e-6 for one no optimizer has stepped."""
    opts = [o for o in (getattr(task, n, None) for n in ("opt", "opt_g", "opt_d", "opt_pf")) if o is not None]
    top = {id(o): max([float(p.grad.abs().max()) for g in o.param_groups for p in g["params"]
                       if p.grad is not None] or [0.0]) for o in opts}
    out = {}
    for i, module in enumerate(modules):
        for n, p in module.named_parameters():
            opt = next((o for o in opts if p in o.state and float(o.state[p]["step"]) > 0), None)
            out[f"{i}.{n}"] = adam_atol(opt, p, top[id(opt)]) if opt is not None else np.full(p.shape, 1e-6)
    return out


# -- Dict-TTS ---------------------------------------------------------------------------------

V, L, E, P, M = 40, 12, 32, 6, 80
B, TW, T = 4, 8, 144
# the rows of rank 0 (0, 1) and rank 1 (2, 3) differ in frames and in words
LENGTHS = (T, 60, 100, 122)
DICT_CFG = dict(word_size=V, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dropout=0.0,
                predictor_dropout=0.0, value_embedding_size=30, dict_embed_dim=E,
                dur_predictor_layers=2, dur_predictor_kernel=3, latent_size=4,
                fvae_enc_dec_hidden=16, fvae_kernel_size=3, fvae_enc_n_layers=1, fvae_dec_n_layers=1,
                prior_glow_hidden=8, glow_kernel_size=3, prior_glow_n_blocks=1,
                mel_disc_hidden_size=8, disc_dropout=0.0, warmup_updates=1)
U = np.array([0.3, 0.8, 0.45], np.float32)  # the discriminator's crop-start uniforms


def dict_bank(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    km = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    km[4] = 0  # an all-masked word
    return {"keys": (rng.randn(V, L, E) * 0.5).astype(np.float32), "key_map": km,
            "pinyin": rng.randint(1, 30, (V, P)).astype(np.int32),
            "pinyin_map": np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1))}


def dict_batch(seed: int, lengths=LENGTHS) -> dict:
    """Collater-format batch: BOS + words of 8-20 frames, mels zero past
    each row's length."""
    rng = np.random.RandomState(seed)
    n = len(lengths)
    wt = np.zeros((n, TW), np.int32)
    m2w = np.zeros((n, T), np.int32)
    wl = np.zeros(n, np.int32)
    for b, n_frames in enumerate(lengths):
        f, w = 0, 0
        while f < n_frames and w < TW:
            d = min(rng.randint(8, 21), n_frames - f)
            m2w[b, f:f + d] = w + 1
            f, w = f + d, w + 1
        wt[b, :w] = rng.randint(5, V, w)
        wt[b, 0] = 1
        wl[b] = w
    mels = (rng.randn(n, T, M) * 0.5 - 2).astype(np.float32) * (m2w > 0)[:, :, None]
    pron = np.where(rng.rand(n, TW) < 0.2, 1, 0).astype(np.int32) * (wt > 0)
    return {"word_tokens": wt, "pron_modified": pron, "mel2word": m2w, "mels": mels,
            "word_lengths": wl, "mel_lengths": np.array(lengths, np.int32)}


def dict_eps(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(B, T // 4, DICT_CFG["latent_size"]).astype(np.float32)


def crop_starts(lengths, u=U, t=T) -> torch.Tensor:
    """The JAX discriminator's crop starts for uniforms u over the global
    batch's longest sequence (float32 math)."""
    max_len = int(np.max(lengths))
    out = []
    for ui, win in zip(u, (32, 64, 128)):
        s = int(np.floor(np.float32(ui) * np.float32(max(max_len - win, 0) + 1)))
        out.append(min(max(s, 0), max(t - win, 0)))
    return torch.tensor(out, dtype=torch.int64)


def dict_task(state: dict | None = None, **cfg) -> DictTTSTask:
    task = DictTTSTask({**DICT_CFG, **cfg}, bank=dict_bank(), device="cpu")
    task.build_state(0)
    if state is not None:
        task.model.load_state_dict(state["g"])
        task.disc.load_state_dict(state["d"])
    return task


def dict_tts_steps(state: dict, batches: list, noise: list, cfg: dict | None = None,
                   keep_task: bool = False) -> dict:
    """Train steps of the Dict-TTS task on this rank's rows, with pinned
    noise and crop starts; the metrics of each step and the weights after
    (and the task itself with ``keep_task``)."""
    task = dict_task(state, **(cfg or {}))
    mesh.broadcast_state(task.state_dict())
    metrics, atol = [], {}
    for batch, eps in zip(batches, noise):
        starts = crop_starts(batch["mel_lengths"])
        m = task.train_step(task.to_device(mesh.shard_batch(batch)), None,
                            eps=torch.tensor(local(eps)), start_frames_g=starts, start_frames_d=starts)
        metrics.append({k: float(v) for k, v in m.items()})
        if keep_task:  # each update adds its Adam term to the parameters' tolerance
            for k, v in update_atol(task, (task.model, task.disc)).items():
                atol[k] = atol.get(k, 0.0) + v
    return {"metrics": metrics, "params": params(task.model, task.disc),
            "updates": (task.step, task.updates_g, task.updates_d),
            **({"task": task, "atol": atol} if keep_task else {})}


def dict_tts_grads(state: dict, batch: dict, eps: np.ndarray) -> dict:
    """The generator and discriminator losses and their gradients averaged
    over the ranks, as the update sees them (no update)."""
    task = dict_task(state)
    tb = task.to_device(mesh.shard_batch(batch))
    starts = crop_starts(batch["mel_lengths"])
    task.model.train()
    task.disc.train()
    loss_g, g_losses, out = task._gen_losses(tb, None, True, 1.0, torch.tensor(local(eps)), starts)
    loss_g.backward()
    loss_d, d_losses = task._disc_losses(out["mel_out"].detach(), tb["mels"], tb["mel_lengths"], None,
                                         starts)
    loss_d.backward()
    mesh.all_reduce_grads(list(task.model.parameters()))
    mesh.all_reduce_grads(list(task.disc.parameters()))
    losses = mesh.reduce_metrics({**{k: v.detach() for k, v in {**g_losses, **d_losses}.items()},
                                  "total": loss_g.detach(), "disc": loss_d.detach()})
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads_g": {n: p.grad.clone() for n, p in task.model.named_parameters()},
            "grads_d": {n: p.grad.clone() for n, p in task.disc.named_parameters()}}


# -- FastSpeech2, HiFi-GAN, PortaSpeech's second stage -----------------------------------------

NV, TT, TM = 24, 12, 48
FS2_CFG = dict(n_vocab=NV, hidden_size=32, encoder_type="rel_fft", decoder_type="conv", enc_layers=1,
               dec_layers=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=5, num_heads=2, dropout=0.0,
               predictor_dropout=0.0, predictor_kernel=3, pitch_norm="standard",
               mel_loss="l1:0.5|ssim:0.5", lr=0.05, warmup_updates=1, weight_decay=0.01,
               clip_grad_norm=1.0)


def fs2_batch(seed: int, phones=(10, 6, 8, 4), lengths=(TM, 31, 40, 20)) -> dict:
    """'fs' batch whose halves differ in phones and frames."""
    rng = np.random.RandomState(seed)
    n = len(lengths)
    tokens = np.zeros((n, TT), np.int32)
    mel2ph = np.zeros((n, TM), np.int32)
    for b, (n_ph, n_fr) in enumerate(zip(phones, lengths)):
        tokens[b, :n_ph] = rng.randint(1, NV, n_ph)
        cuts = np.sort(rng.choice(np.arange(1, n_fr), n_ph - 1, replace=False))
        mel2ph[b, :n_fr] = np.searchsorted(cuts, np.arange(n_fr), side="right") + 1
    real = mel2ph > 0
    mels = ((rng.randn(n, TM, M) * 0.6 - 3) * real[:, :, None]).astype(np.float32)
    uv = ((rng.rand(n, TM) < 0.3) | ~real).astype(np.float32)
    f0 = (rng.uniform(100, 300, (n, TM)) * real).astype(np.float32)
    return {"txt_tokens": tokens, "mel2ph": mel2ph, "mels": mels, "f0": f0, "uv": uv,
            "mel_lengths": np.array(lengths, np.int32)}


def fs2_step(batch: dict, keep_task: bool = False) -> dict:
    task = FastSpeech2Task(dict(FS2_CFG), device="cpu")
    task.build_state(0)
    task.model.pitch_predictor.dropout_rate = 0.0
    m = task.train_step(task.to_device(mesh.shard_batch(batch)), torch.Generator().manual_seed(0))
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": params(task.model),
            **({"task": task} if keep_task else {})}


SEG = 1024
HIFI_CFG = dict(upsample_initial_channel=16, max_samples=SEG, disc_start_steps=0, use_ms_stft=True,
                use_fm_loss=True)


def hifigan_batch(seed: int, n: int = 4) -> dict:
    rng = np.random.RandomState(seed)
    scale = np.array([0.3, 0.05, 0.2, 0.6][:n], np.float32)[:, None]  # the halves differ in energy
    return {"wavs": (scale * rng.randn(n, SEG)).astype(np.float32),
            "mels": rng.uniform(-5, 0, (n, SEG // 256, 80)).astype(np.float32)}


def hifigan_step(batch: dict, keep_task: bool = False) -> dict:
    task = HifiGanTask(dict(HIFI_CFG), device="cpu")
    task.build_state(0)
    m = task.train_step(task.to_device(mesh.shard_batch(batch)))
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": params(task.model, task.disc),
            **({"task": task} if keep_task else {})}


NPH, TPW, TPS = 30, 6, 96  # PortaSpeech: phone vocabulary, words, frames
PS_CFG = dict(n_vocab=NPH, hidden_size=16, num_heads=2, enc_layers=1, word_enc_layers=1,
              enc_ffn_kernel_size=3, dropout=0.0, predictor_dropout=0.0, dur_predictor_layers=2,
              dur_predictor_kernel=3, latent_size=4, fvae_enc_dec_hidden=8, fvae_kernel_size=3,
              fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8, glow_kernel_size=3,
              prior_glow_n_blocks=1, mel_disc_hidden_size=8, post_glow_hidden=8,
              post_glow_n_blocks=2, post_glow_n_block_layers=1, share_wn_layers=2,
              use_post_glow=True, post_glow_training_start=0, post_glow_lr=0.02, disc_dropout=0.0)


def ps_batch(seed: int, lengths=(TPS, 70, 50, 88)) -> dict:
    """Collater-format word batch (BOS word, words of 1-3 phones and 8-20
    frames) whose halves differ in frames and words."""
    rng = np.random.RandomState(seed)
    n, tph = len(lengths), 16
    ph2word = np.zeros((n, tph), np.int32)
    m2w = np.zeros((n, TPS), np.int32)
    wl = np.zeros(n, np.int32)
    for b, n_frames in enumerate(lengths):
        f, w, p = 0, 0, 0
        while f < n_frames and w < TPW:
            n_ph = min(rng.randint(1, 4), tph - p)
            ph2word[b, p:p + n_ph] = w + 1
            d = min(rng.randint(8, 21), n_frames - f)
            m2w[b, f:f + d] = w + 1
            f, w, p = f + d, w + 1, p + n_ph
        wl[b] = w
    txt = np.where(ph2word > 0, rng.randint(1, NPH, ph2word.shape), 0).astype(np.int32)
    wt = np.where(np.arange(TPW)[None] < wl[:, None], rng.randint(3, 50, (n, TPW)), 0).astype(np.int32)
    mels = (rng.randn(n, TPS, M) * 0.5 - 2).astype(np.float32) * (m2w > 0)[:, :, None]
    return {"txt_tokens": txt, "ph2word": ph2word, "word_tokens": wt, "mel2word": m2w, "mels": mels,
            "word_lengths": wl, "mel_lengths": np.array(lengths, np.int32)}


def ps_flow_step(batch: dict, eps: np.ndarray, keep_task: bool = False) -> dict:
    """One second-stage step (the post-flow NLL and its optimizer)."""
    task = PortaSpeechFlowTask(dict(PS_CFG), device="cpu")
    task.build_state(0)
    m = task.train_step(task.to_device(mesh.shard_batch(batch)), None, eps=torch.tensor(local(eps)))
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": params(task.model),
            "updates": (task.step, task.updates_g, task.updates_pf), **({"task": task} if keep_task else {})}


def nan_step(state: dict, batch: dict, eps: np.ndarray) -> dict:
    """A Dict-TTS step whose rank-1 rows carry a NaN mel, then a step on
    clean rows: the weights before and after the first, its reported
    losses, and the counters after each."""
    task = dict_task(state, disc_start_steps=5)
    before = params(task.model, task.disc)
    starts = crop_starts(batch["mel_lengths"])

    def step(b):
        return task.train_step(task.to_device(mesh.shard_batch(b)), None, eps=torch.tensor(local(eps)),
                               start_frames_g=starts, start_frames_d=starts)

    m = step(batch)
    after = params(task.model, task.disc)
    counts = (task.step, task.updates_g, task.updates_d)
    step(dict_batch(3))  # every rank goes on to the next step's collectives
    return {"metrics": {k: float(v) for k, v in m.items()}, "before": before, "after": after,
            "updates": counts, "updates_next": (task.step, task.updates_g, task.updates_d)}


def state_of(task) -> dict:
    return {"g": {k: v.clone() for k, v in task.model.state_dict().items()},
            "d": {k: v.clone() for k, v in task.disc.state_dict().items()}}
