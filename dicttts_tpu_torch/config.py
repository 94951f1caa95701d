"""Hierarchical YAML configuration: inheritance, overrides and persistence.

Port of ``dicttts_tpu/config.py``. ``load_config`` returns a plain dict:

- a ``base_config`` key (a path or a list of paths, ``./`` and ``../``
  relative to the including file) pulls in bases first; later bases and
  the leaf override earlier ones key by key (``deep_merge``); a file is
  read once per chain;
- ``"a=1,b.c=2,d=[1 1 1]"`` override strings, each value coerced to the
  type of the value it replaces (``parse_override_string``);
- the merged config is saved to ``<work_dir>/config.yaml`` on a run's first
  start, and a later start reads it back over the YAML tree unless
  ``reset``.

Unlike the JAX package, a config file that does not exist raises instead
of counting as empty.
"""

from __future__ import annotations

import ast
import os
from typing import Any

import yaml

CONFIG_ROOT = os.path.join(os.path.dirname(__file__), "configs")


def deep_merge(dst: dict, src: dict) -> dict:
    """Recursively merge ``src`` into ``dst`` (in place). ``src`` wins."""
    for key, val in src.items():
        if isinstance(val, dict) and isinstance(dst.get(key), dict):
            deep_merge(dst[key], val)
        else:
            dst[key] = val
    return dst


def _resolve_base(path: str, including_file: str) -> str:
    if path.startswith("."):
        path = os.path.normpath(os.path.join(os.path.dirname(including_file), path))
    return path


def _load_yaml_tree(config_fn: str, visited: set[str]) -> dict:
    with open(config_fn) as f:
        leaf = yaml.safe_load(f) or {}
    visited.add(config_fn)
    bases = leaf.pop("base_config", None)
    if bases is None:
        return leaf
    if not isinstance(bases, list):
        bases = [bases]
    merged: dict = {}
    for base in bases:
        base = _resolve_base(base, config_fn)
        if base not in visited:
            deep_merge(merged, _load_yaml_tree(base, visited))
    deep_merge(merged, leaf)
    return merged


def parse_override_string(overrides: str, config: dict) -> dict:
    """Apply ``"a=1,b.c=2"``-style overrides in place, with type coercion.

    If the existing value is a bool, list or dict, or the literal is
    True/False, the string is parsed as a Python literal (spaces inside
    ``[...]`` become commas); otherwise it is cast to the existing value's
    type; a new key is parsed as a literal where it can be, else kept as a
    string.
    """
    for item in overrides.split(","):
        if not item.strip():
            continue
        key, val = item.split("=", 1)
        val = val.strip("'\" ")
        node = config
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        leaf_key = parts[-1]
        old = node.get(leaf_key)
        if val in ("True", "False") or isinstance(old, (bool, list, dict)):
            if isinstance(old, list):
                val = val.replace(" ", ",")
            node[leaf_key] = ast.literal_eval(val)
        elif old is not None:
            node[leaf_key] = type(old)(val)
        else:
            if val.startswith("["):
                val = val.replace(" ", ",")
            try:
                node[leaf_key] = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                node[leaf_key] = val
    return config


def load_config(
    config: str = "",
    exp_name: str = "",
    overrides: str = "",
    reset: bool = False,
    infer: bool = False,
    checkpoints_root: str = "checkpoints",
    save: bool = True,
) -> dict:
    """Resolve the full config for an experiment.

    Order of precedence (low to high): the YAML inheritance chain, the
    saved ``<work_dir>/config.yaml`` (unless ``reset``), ``overrides``.
    ``work_dir`` is ``<checkpoints_root>/<exp_name>``.
    """
    if not (config or exp_name):
        raise ValueError("need a config path or an exp_name")
    work_dir = os.path.join(checkpoints_root, exp_name) if exp_name else ""
    saved: dict = {}
    saved_cfg_path = os.path.join(work_dir, "config.yaml") if work_dir else ""
    if saved_cfg_path and os.path.exists(saved_cfg_path):
        with open(saved_cfg_path) as f:
            saved = yaml.safe_load(f) or {}

    merged: dict = {}
    if config:
        deep_merge(merged, _load_yaml_tree(config, set()))
    if not reset:
        deep_merge(merged, saved)
    merged["work_dir"] = work_dir
    if overrides:
        parse_override_string(overrides, merged)
    if work_dir and save and not infer and (not os.path.exists(saved_cfg_path) or reset):
        os.makedirs(work_dir, exist_ok=True)
        with open(saved_cfg_path, "w") as f:
            yaml.safe_dump(merged, f)
    merged["exp_name"] = exp_name
    merged["infer"] = infer
    return merged


class Config:
    """Immutable attribute/key access view over a resolved config dict."""

    __slots__ = ("_d",)

    def __init__(self, d: dict):
        object.__setattr__(self, "_d", dict(d))

    def __getitem__(self, key: str) -> Any:
        return self._d[key]

    def __getattr__(self, key: str) -> Any:
        try:
            return self._d[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key, default)

    def __setattr__(self, key: str, value: Any):
        raise AttributeError("Config is immutable")

    def to_dict(self) -> dict:
        return dict(self._d)

    def replace(self, **kwargs) -> "Config":
        d = dict(self._d)
        d.update(kwargs)
        return Config(d)

    def __repr__(self) -> str:
        return f"Config({self._d!r})"
