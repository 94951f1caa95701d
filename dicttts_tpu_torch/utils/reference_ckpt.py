"""Load the reference implementation's PyTorch checkpoints into the port.

Counterpart of ``dicttts_tpu/utils/torch_convert.py``, which turns the
reference's checkpoints into flax parameters. The port keeps the
reference's parameter names and torch layouts (``convert.py``), so no
renaming or transposing is needed here; what is left:

- ``load_torch_checkpoint(path)`` reads the reference's formats into one
  flat {name: tensor} dict: a task checkpoint ``{'state_dict': {'model':
  {...}, 'mel_disc': {...}}}`` (each child flattened to ``model.xxx``), a
  vocoder's ``{'state_dict': {'model_gen': ...}}`` or ``{'generator':
  ...}``, or a plain state dict. Non-tensor entries are skipped.
- weight norm is folded: every ``X.weight_g`` / ``X.weight_v`` pair becomes
  ``X.weight = g * v / ||v||``, the norm over every axis but 0 (torch's
  ``weight_norm`` default), in the JAX converter's arithmetic
  (``fold_weight_norm``);
- ``load_reference_dict_tts`` drops exactly the keys the JAX converter
  documents as unused (``convert_dict_tts``): the base class's word-to-frame
  attention stack (``sin_pos``, ``enc_pos_proj``, ``dec_query_proj``,
  ``dec_res_proj``, ``attn``), which ``PortaSpeech_dict`` never runs, and the
  dead ``emb`` of ``S2PATextEncoder``;
- both loaders then call ``load_state_dict(strict=True)``, so any other
  missing or unexpected key raises and names itself. Depths come from the
  module, not from arguments.

Only read checkpoints from a source you trust: the reference's files are
pickles, and reading them runs code.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# convert_dict_tts (dicttts_tpu/utils/torch_convert.py) reads none of these
DICT_TTS_UNUSED = ("sin_pos.", "enc_pos_proj.", "dec_query_proj.", "dec_res_proj.", "attn.",
                   "dict_encoder.S2PA_module.emb.")


def load_torch_checkpoint(path: str) -> dict:
    """A reference .ckpt/.pt file -> a flat {name: CPU tensor} dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model_gen", "generator"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
    out = {}
    for k, v in ckpt.items():
        if isinstance(v, dict):  # a child module's state_dict
            out.update({f"{k}.{kk}": vv.detach().cpu() for kk, vv in v.items()
                        if isinstance(vv, torch.Tensor)})
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu()
    return out


def strip_prefix(state: dict, prefix: str) -> dict:
    """The keys under ``prefix`` (e.g. 'model.'), with it removed."""
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def fold_weight_norm(v: np.ndarray, g: np.ndarray, dim: int = 0) -> np.ndarray:
    """w = g * v / ||v||, the norm over every axis but ``dim``."""
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt(np.sum(v**2, axis=axes, keepdims=True))
    g = np.reshape(g, norm.shape)
    return (g * v / np.maximum(norm, 1e-12)).astype(v.dtype)


def fold_all_weight_norms(state: dict) -> tuple[dict, int]:
    """Every ``X.weight_g`` / ``X.weight_v`` pair replaced by ``X.weight``;
    returns (the new dict, the number of pairs folded). A lone half raises."""
    out, folded = {}, 0
    for k, v in state.items():
        if k.endswith(".weight_v"):
            base = k[:-len("_v")]
            g = state.get(base + "_g")
            if g is None:
                raise KeyError(f"{k} has no {base}_g")
            w = fold_weight_norm(v.float().numpy(), g.float().numpy())
            out[base] = torch.from_numpy(w).to(v.dtype)
            folded += 1
        elif k.endswith(".weight_g"):
            if k[:-len("_g")] + "_v" not in state:
                raise KeyError(f"{k} has no {k[:-len('_g')]}_v")
        else:
            out[k] = v
    return out, folded


def _load(module: nn.Module, state: dict, unused: tuple[str, ...]) -> dict:
    state, folded = fold_all_weight_norms(state)
    dropped = sorted(k for k in state if k.startswith(unused))
    module.load_state_dict({k: v for k, v in state.items() if not k.startswith(unused)}, strict=True)
    return {"folded": folded, "dropped": dropped}


def load_reference_dict_tts(module: nn.Module, state: dict) -> dict:
    """Load a reference ``PortaSpeech_dict`` state dict (the task
    checkpoint's ``model.`` child, prefix stripped) into the port's
    ``DictTTS``. Returns {'folded': pairs folded, 'dropped': the unused keys
    left out}."""
    return _load(module, state, DICT_TTS_UNUSED)


def load_reference_hifigan(module: nn.Module, state: dict) -> dict:
    """Load a reference ``HifiGanGenerator`` state dict into the port's
    generator. Returns {'folded': pairs folded, 'dropped': []}."""
    return _load(module, state, ())
