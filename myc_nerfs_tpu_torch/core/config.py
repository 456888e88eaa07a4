"""Config loading (counterpart of myc_nerfs_tpu/core/config.py).

Python-module configs with ``_base_`` file inheritance and ``_cover_``
subtree replacement (jnerf utils/config.py:33-101), as ``configs/ngp/*.py``
use them. ``yaml`` is imported only when a ``.yaml`` config is loaded.
"""
from __future__ import annotations

import copy
import importlib.util
import os
from typing import Any, Dict, Optional


class Config(dict):
    """Nested dict with attribute access (edict-style)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(d: Any) -> Any:
        if isinstance(d, dict):
            return Config({k: Config.wrap(v) for k, v in d.items()})
        if isinstance(d, list):
            return [Config.wrap(v) for v in d]
        return d


def _module_globals(path: str) -> Dict[str, Any]:
    spec = importlib.util.spec_from_file_location("_cfg_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(importlib))}


def _merge(base: Dict, child: Dict) -> Dict:
    """Recursive merge; a child subtree with ``_cover_: True`` replaces the
    base subtree outright."""
    out = copy.deepcopy(base)
    for k, v in child.items():
        if isinstance(v, dict) and v.pop("_cover_", False):
            out[k] = copy.deepcopy(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_py_config(path: str) -> Config:
    """Python-module config with ``_base_`` inheritance."""
    cfg = _module_globals(path)
    base = cfg.pop("_base_", None)
    if base:
        bases = base if isinstance(base, (list, tuple)) else [base]
        merged: Dict[str, Any] = {}
        for b in bases:
            bpath = os.path.join(os.path.dirname(path), b)
            merged = _merge(merged, dict(load_py_config(bpath)))
        cfg = _merge(merged, cfg)
    return Config.wrap(cfg)


def load_yaml_config(path: str) -> Config:
    """YAML config with ``_parent_`` chains (barf options.py:54-67)."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parent = cfg.pop("_parent_", None)
    if parent:
        candidates = [parent,
                      os.path.join(os.path.dirname(path), parent),
                      os.path.join(os.path.dirname(path),
                                   os.path.basename(parent))]
        ppath = next((c for c in candidates if os.path.exists(c)), parent)
        cfg = _merge(dict(load_yaml_config(ppath)), cfg)
    return Config.wrap(cfg)


def load_config(path: str) -> Config:
    if path.endswith(".py"):
        return load_py_config(path)
    return load_yaml_config(path)


_global_cfg: Optional[Config] = None


def init_cfg(cfg_or_path) -> Config:
    """Set the global config singleton (jnerf config.py:144-155)."""
    global _global_cfg
    _global_cfg = (load_config(cfg_or_path) if isinstance(cfg_or_path, str)
                   else Config.wrap(cfg_or_path))
    return _global_cfg


def get_cfg() -> Optional[Config]:
    return _global_cfg
