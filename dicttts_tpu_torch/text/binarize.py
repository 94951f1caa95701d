"""Command line of the offline pipeline: pre-align, then binarize.

Port of ``dicttts_tpu/text/binarize.py``:

    python -m dicttts_tpu_torch.text.binarize --config <cfg.yaml> \\
        [--stage all|pre_align|binarize] [--hparams "a=1,b=2"] [--device cuda]

The classes are the config's ``pre_align_cls`` and ``binarizer_cls``
(default ``BiaobeiPreAlign`` and ``ZhBinarizer``); the configs name the
JAX package's classes, and a name in ``dicttts_tpu.`` resolves to the
port's class of the same module path. The mel and f0 run on
``--device``: the card by default, which raises without one; ``cpu`` runs
them on the host (for tests). There is no fall-back to the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import logging

from dicttts_tpu_torch.config import load_config

PACKAGE = "dicttts_tpu_torch."
JAX_PACKAGE = "dicttts_tpu."


def _cls(path: str):
    """The port's class that ``path`` names (in either package)."""
    if path.startswith(JAX_PACKAGE):
        path = PACKAGE + path[len(JAX_PACKAGE):]
    if not path.startswith(PACKAGE):
        raise NotImplementedError(f"{path} is not a class of {PACKAGE[:-1]}")
    mod, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)


def main(argv=None):
    """Run the command line ``argv``; returns (pre-aligner or None,
    binarizer or None)."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="dicttts_tpu_torch offline pipeline")
    p.add_argument("--config", required=True)
    p.add_argument("--exp_name", default="")
    p.add_argument("--hparams", default="")
    p.add_argument("--stage", default="all", choices=["all", "pre_align", "binarize"])
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    cfg = load_config(config=args.config, exp_name=args.exp_name, overrides=args.hparams, save=False)
    pre = binarizer = None
    if args.stage in ("all", "binarize"):  # built first: a missing card raises before any work
        binarizer = _cls(cfg.get("binarizer_cls", PACKAGE + "text.binarizer.ZhBinarizer"))(
            cfg, device=args.device)
    if args.stage in ("all", "pre_align"):
        pre = _cls(cfg.get("pre_align_cls", PACKAGE + "text.binarizer.BiaobeiPreAlign"))(cfg)
        pre.process()
    if binarizer is not None:
        binarizer.process()
    return pre, binarizer


if __name__ == "__main__":
    main()
