"""Convert the reference implementation's PyTorch checkpoints into port checkpoints.

Counterpart of ``scripts/convert_torch_ckpt.py``:

    # HiFi-GAN vocoder generator (the reference's released hifigan_hifitts)
    python -m dicttts_tpu_torch.tools.convert_torch_ckpt --model hifigan \\
        --src pretrained/hifigan_hifitts/model_ckpt_steps_2168000.ckpt \\
        --dst checkpoints/hifigan_converted

    # the Dict-TTS acoustic model (the released dicttts_biaobei_wo_gumbel)
    python -m dicttts_tpu_torch.tools.convert_torch_ckpt --model dict_tts \\
        --src checkpoints/dicttts_biaobei_wo_gumbel/model_ckpt_steps_300000.ckpt \\
        --dst checkpoints/dicttts_converted \\
        --hparams binary_data_dir=data/binary/biaobei

The model is built at the recipe's widths
(``configs/datasets/biaobei/dict_tts.yaml`` or ``hifigan.yaml``) with
``--hparams`` over them, and its vocabulary sizes from ``binary_data_dir``
where that holds a binarized corpus (as ``run.py`` derives them). The
weights load with strict key checks (``utils/reference_ckpt.py``): weight
norm folded, the reference's unused keys dropped, any other mismatch
raises. The output is ``<dst>/model_ckpt_steps_<step>.ckpt`` holding
``{'params_g': state_dict}``: ``DictTTSInferencer`` (``infer.py``) and
``HifiGanVocoder`` (``vocoder_ckpt``) read it as they read a trained
checkpoint, and ``utils/checkpoint.load_partial`` loads it into a task's
generator for fine-tuning. ``run.py --infer`` needs a whole train state
(optimizers and discriminator), as in the JAX package, and does not read
it. Runs on the CPU: no card is needed.
"""

from __future__ import annotations

import argparse
import os

import torch

from dicttts_tpu_torch.config import load_config
from dicttts_tpu_torch.run import autoconfigure_vocabs
from dicttts_tpu_torch.utils.checkpoint import save_checkpoint
from dicttts_tpu_torch.utils.reference_ckpt import (
    load_reference_dict_tts,
    load_reference_hifigan,
    load_torch_checkpoint,
    strip_prefix,
)

CONFIGS = {"dict_tts": "dict_tts.yaml", "hifigan": "hifigan.yaml"}
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "datasets", "biaobei")


def build_module(model: str, cfg: dict) -> torch.nn.Module:
    """The port's generator for ``model`` at ``cfg``'s widths."""
    if model == "hifigan":
        from dicttts_tpu_torch.vocoders.hifigan import build_generator

        return build_generator(cfg)
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

    return DictTTSTask(autoconfigure_vocabs(dict(cfg)), device="cpu").build_model()


def main(argv=None) -> dict:
    """Run the command line ``argv``; returns {'path', 'params', 'folded',
    'dropped'}."""
    p = argparse.ArgumentParser(description="convert a reference torch checkpoint")
    p.add_argument("--src", required=True, help="torch .ckpt/.pt path")
    p.add_argument("--dst", required=True, help="output work dir")
    p.add_argument("--model", choices=sorted(CONFIGS), default="hifigan")
    p.add_argument("--step", type=int, default=0)
    p.add_argument("--hparams", default="", help="overrides of the recipe's config, 'a=1,b=2'")
    args = p.parse_args(argv)

    cfg = load_config(config=os.path.join(CONFIG_DIR, CONFIGS[args.model]), overrides=args.hparams, save=False)
    module = build_module(args.model, cfg)
    state = load_torch_checkpoint(args.src)
    if args.model == "hifigan":
        report = load_reference_hifigan(module, state)
    else:
        # the reference task saves the model under its 'model.' child
        if any(k.startswith("model.") for k in state):
            state = strip_prefix(state, "model.")
        report = load_reference_dict_tts(module, state)
    path = save_checkpoint(args.dst, args.step, {"params_g": module.state_dict()}, keep=1)
    n = sum(p.numel() for p in module.parameters())
    print(f"| converted {n / 1e6:.2f}M params ({args.model}; {report['folded']} weight-norm pairs "
          f"folded, {len(report['dropped'])} unused keys dropped) -> {path}")
    return {"path": path, "params": n, **report}


if __name__ == "__main__":
    main()
