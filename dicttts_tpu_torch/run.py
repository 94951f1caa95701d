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
kernels' plain versions (for tests). Not ported: ``--multihost`` and the
JAX package's random-number switch.
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

    def __init__(self, cfg: dict, data_dir: str, kind: str):
        def split(name_key, default, split_cfg=cfg, **kw):
            ds = TTSBinaryDataset(data_dir, cfg.get(name_key, default), cfg, kind)
            return TTSBatchProvider(ds, split_cfg, **kw)

        # with the frame cache, train batches carry item_idx in place of mels
        self.train = split("train_set_name", "train", shuffle=True,
                           emit_frame_refs=bool(cfg.get("use_device_frame_cache")))
        self.valid = split("valid_set_name", "valid", shuffle=False)
        self.test = split("test_set_name", "test", split_cfg=dict(cfg, max_sentences=1), shuffle=False)
        self.ds = self.train.ds

    def train_batches(self):
        return self.train.train_batches()

    def val_batches(self):
        return self.valid.val_batches()

    def test_batches(self):
        return self.test.test_batches()


def build_data_provider(cfg: dict):
    """The task's batches: ``VocoderDataset`` crops of the train split for
    HiFi-GAN (its train, validation and test batches alike, as in the JAX
    package), else the three splits' providers."""
    data_dir = cfg.get("binary_data_dir", "")
    # a split is .data/.idx or .rio/.rix (the JAX package requires train.idx
    # even where train.rio exists)
    if not data_dir or not any(os.path.exists(os.path.join(data_dir, f"train{ext}"))
                               for ext in (".idx", ".rio")):
        raise FileNotFoundError(
            f"binary_data_dir {data_dir!r} has no binaries; binarize the corpus first "
            "(python -m dicttts_tpu_torch.text.binarize --config ...)")
    if "hifigan" in cfg.get("task_cls", "").lower():
        return VocoderDataset(data_dir, cfg.get("train_set_name", "train"), cfg,
                              batch_size=cfg.get("max_sentences", 24))
    kind = "dict" if cfg.get("use_dict") else ("word" if cfg.get("dur_level") == "word" else "fs")
    return _Splits(cfg, data_dir, kind)


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
    args = parser.parse_args(argv)

    cfg = load_config(config=args.config, exp_name=args.exp_name, overrides=args.hparams,
                      reset=args.reset, infer=args.infer)
    task_cls = task_class(cfg["task_cls"])
    autoconfigure_vocabs(cfg)
    data = build_data_provider(cfg)
    task = task_cls(cfg, data, device=args.device)
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
        device=args.device,
    )
    if args.infer:
        outputs = trainer.test(task)
        logging.info("inference done: %d batches", len(outputs))
    else:
        trainer.fit(task)
    return trainer, task


if __name__ == "__main__":
    main()
