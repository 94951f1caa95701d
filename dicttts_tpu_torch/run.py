"""Command-line entry: train a task from its config, or run its test split.

Port of ``dicttts_tpu/run.py``: resolve the config chain, derive the
vocabulary sizes from the binarized corpus, build the data provider (the
three splits' batches, or HiFi-GAN's ``VocoderDataset`` crops), the task
named by ``task_cls`` (``DictTTSTask``, ``PortaSpeechAdvTask``,
``PortaSpeechFlowTask``, ``FastSpeech2Task`` or ``HifiGanTask``) and the
trainer, then train, or with ``--infer`` run the test loop (Dict-TTS writes
``<work_dir>/generated/`` and its ``meta.csv``).

    python -m dicttts_tpu_torch.run \\
        --config dicttts_tpu_torch/configs/datasets/biaobei/dict_tts.yaml \\
        --exp_name dicttts_biaobei [--infer] [--hparams "a=1,b.c=2"] [--reset] [--device cuda]
    python -m dicttts_tpu_torch.run \\
        --config dicttts_tpu_torch/configs/datasets/biaobei/ps_flow.yaml \\
        --exp_name ps_flow_biaobei --hparams "use_post_glow=True"
    python -m dicttts_tpu_torch.run \\
        --config dicttts_tpu_torch/configs/datasets/biaobei/fs2.yaml --exp_name fs2_biaobei

``--device`` defaults to the card and raises without one; ``cpu`` runs the
kernels' plain versions (for tests). The config's ``steps_per_dispatch``
(16 in ``configs/base.yaml``) groups the trainer's steps as the JAX
trainer does; on the card a Dict-TTS step of a group replays a CUDA graph
(``train/trainer.py``, ``train/graphs.py``).

Data parallelism, the JAX package's mesh over every device: under
``torchrun`` (``WORLD_SIZE`` > 1) each process joins the group, ``cuda`` as
``cuda:LOCAL_RANK`` with NCCL and ``cpu`` with gloo, and trains on its rows
of each global batch (``parallel/mesh.py``); the train and valid batches
are cut to multiples of the world size, the test split's are not.
``--multihost`` also reads the JAX package's ``DICTTTS_COORDINATOR``
(host:port), ``DICTTTS_NUM_PROCESSES`` and ``DICTTTS_PROCESS_ID``, one
process per card. A failed join raises; nothing drops to one process.

    torchrun --nproc_per_node=8 -m dicttts_tpu_torch.run --config ... --exp_name X
    DICTTTS_COORDINATOR=host0:29500 DICTTTS_NUM_PROCESSES=16 DICTTTS_PROCESS_ID=<i> \
        LOCAL_RANK=<card> python -m dicttts_tpu_torch.run --multihost --config ... --exp_name X

Not ported: the JAX package's random-number switch (``DICTTTS_RNG_IMPL``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import pickle

from dicttts_tpu_torch.config import load_config
from dicttts_tpu_torch.data.datasets import TTSBatchProvider, TTSBinaryDataset, VocoderDataset
from dicttts_tpu_torch.parallel import mesh
from dicttts_tpu_torch.train.trainer import Trainer

PACKAGE = "dicttts_tpu_torch."


def autoconfigure_vocabs(cfg: dict) -> dict:
    """Vocabulary sizes from the binarized corpus: n_vocab from
    phone_set.json, word_size from word_set.json (each + 3 reserved ids),
    value_embedding_size from pinyin_encoder.pkl (+ 2)."""
    data_dir = cfg.get("binary_data_dir", "")
    ps = os.path.join(data_dir, "phone_set.json")
    if os.path.exists(ps):
        with open(ps) as f:
            cfg.setdefault("n_vocab", len(json.load(f)) + 3)
    ws = os.path.join(data_dir, "word_set.json")
    if os.path.exists(ws):
        with open(ws) as f:
            cfg["word_size"] = len(json.load(f)) + 3
    pe = os.path.join(data_dir, "pinyin_encoder.pkl")
    if os.path.exists(pe):
        with open(pe, "rb") as f:
            cfg["value_embedding_size"] = len(pickle.load(f)) + 2
    return cfg


class _Splits:
    """The train, valid and test providers of one corpus. ``.ds`` is the
    train split's dataset, from which the task takes the device bank and
    the frame cache."""

    def __init__(self, cfg: dict, data_dir: str, kind: str, devices_multiple: int = 1):
        def split(name_key, default, split_cfg=cfg, **kw):
            ds = TTSBinaryDataset(data_dir, cfg.get(name_key, default), cfg, kind)
            return TTSBatchProvider(ds, split_cfg, **kw)

        # with the frame cache, train batches carry item_idx in place of mels
        self.train = split("train_set_name", "train", shuffle=True,
                           emit_frame_refs=bool(cfg.get("use_device_frame_cache")),
                           devices_multiple=devices_multiple)
        self.valid = split("valid_set_name", "valid", shuffle=False, devices_multiple=devices_multiple)
        self.test = split("test_set_name", "test", split_cfg=dict(cfg, max_sentences=1), shuffle=False)
        self.ds = self.train.ds

    def train_batches(self):
        return self.train.train_batches()

    def val_batches(self):
        return self.valid.val_batches()

    def test_batches(self):
        return self.test.test_batches()


def build_data_provider(cfg: dict, devices_multiple: int = 1):
    """The task's batches: ``VocoderDataset`` crops of the train split for
    HiFi-GAN (its train, validation and test batches alike, as in the JAX
    package; their count must divide by ``devices_multiple``), else the
    three splits' providers, the train and valid batches cut to multiples
    of ``devices_multiple``."""
    data_dir = cfg.get("binary_data_dir", "")
    # a split is .data/.idx or .rio/.rix (the JAX package requires train.idx
    # even where train.rio exists)
    if not data_dir or not any(os.path.exists(os.path.join(data_dir, f"train{ext}"))
                               for ext in (".idx", ".rio")):
        raise FileNotFoundError(
            f"binary_data_dir {data_dir!r} has no binaries; binarize the corpus first "
            "(python -m dicttts_tpu_torch.text.binarize --config ...)")
    if "hifigan" in cfg.get("task_cls", "").lower():
        batch_size = cfg.get("max_sentences", 24)
        if batch_size % devices_multiple:  # its losses average over every crop: no zero rows
            raise ValueError(f"the vocoder's max_sentences ({batch_size}) must be a multiple of the "
                             f"{devices_multiple} data-parallel ranks")
        return VocoderDataset(data_dir, cfg.get("train_set_name", "train"), cfg, batch_size=batch_size)
    kind = "dict" if cfg.get("use_dict") else ("word" if cfg.get("dur_level") == "word" else "fs")
    return _Splits(cfg, data_dir, kind, devices_multiple)


def task_class(task_path: str):
    """The class ``cfg['task_cls']`` names; a task of the JAX package that
    has no counterpart here raises."""
    if not task_path.startswith(PACKAGE):
        raise NotImplementedError(
            f"task {task_path} is not ported to {PACKAGE[:-1]} yet (ROADMAP Queue 1); the port "
            "trains the tasks of dicttts_tpu_torch.train.tasks: dict_tts.DictTTSTask, "
            "ps_adv.PortaSpeechAdvTask, ps_flow.PortaSpeechFlowTask, fs2.FastSpeech2Task and "
            "hifigan.HifiGanTask")
    mod, cls_name = task_path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), cls_name)


def main(argv=None):
    """Run the command line ``argv``; returns (trainer, task)."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="dicttts_tpu_torch runner")
    parser.add_argument("--config", type=str, default="")
    parser.add_argument("--exp_name", type=str, default="")
    parser.add_argument("--hparams", type=str, default="")
    parser.add_argument("--infer", action="store_true")
    parser.add_argument("--reset", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group over several hosts (DICTTTS_COORDINATOR, "
                             "DICTTTS_NUM_PROCESSES, DICTTTS_PROCESS_ID, or torchrun's variables)")
    parser.add_argument("--dist_timeout", type=float, default=mesh.DEFAULT_TIMEOUT_S,
                        help="seconds a collective may wait before it raises")
    args = parser.parse_args(argv)

    device = args.device
    joined = not mesh.initialized() and (args.multihost or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if joined:
        device = mesh.init_distributed(args.device, multihost=args.multihost, timeout_s=args.dist_timeout)
        if not mesh.is_chief():
            logging.getLogger().setLevel(logging.WARNING)  # rank 0 logs
    try:
        return _run(args, device)
    finally:
        if joined:
            mesh.dist.destroy_process_group()


def _run(args, device):
    def config(save: bool) -> dict:
        return load_config(config=args.config, exp_name=args.exp_name, overrides=args.hparams,
                           reset=args.reset, infer=args.infer, save=save)

    # rank 0 writes the work dir's config.yaml; the others read it after
    cfg = config(True) if mesh.is_chief() else None
    mesh.barrier()
    cfg = cfg or config(False)
    task_cls = task_class(cfg["task_cls"])
    autoconfigure_vocabs(cfg)
    data = build_data_provider(cfg, mesh.world_size())
    task = task_cls(cfg, data, device=device)
    trainer = Trainer(
        work_dir=cfg.get("work_dir", ""),
        max_updates=cfg.get("max_updates", 160000),
        val_check_interval=cfg.get("val_check_interval", 2000),
        num_sanity_val_steps=cfg.get("num_sanity_val_steps", 5),
        num_ckpt_keep=cfg.get("num_ckpt_keep", 3),
        log_interval=cfg.get("tb_log_interval", 100),
        eval_max_batches=cfg.get("eval_max_batches", -1),
        monitor_key=cfg.get("valid_monitor_key", "total_loss"),
        monitor_mode=cfg.get("valid_monitor_mode", "min"),
        save_best=cfg.get("save_best", True),
        seed=cfg.get("seed", 1234),
        device=device,
        valid_infer_interval=cfg.get("valid_infer_interval"),
        steps_per_dispatch=cfg.get("steps_per_dispatch", 1),
    )
    if args.infer:
        outputs = trainer.test(task)
        logging.info("inference done: %d batches", len(outputs))
    else:
        trainer.fit(task)
    return trainer, task


if __name__ == "__main__":
    main()
