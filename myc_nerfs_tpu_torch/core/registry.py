"""Registry + build_from_cfg dispatch (counterpart of myc_nerfs_tpu/core/registry.py).

Named registries with a ``type=``-keyed constructor dispatch, so the
config files under ``configs/`` drive the port unchanged. The port keeps
its own seven registries: the JAX package fills its module-level ones,
and one process may import both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    def get(self, key: str) -> Callable:
        if key not in self._module_dict:
            raise KeyError(f"{key} is not registered in {self._name}; "
                           f"known: {sorted(self._module_dict)}")
        return self._module_dict[key]

    def register_module(self, name: Optional[str] = None,
                        module: Optional[Callable] = None):
        if module is not None:
            self._module_dict[name or module.__name__] = module
            return module

        def _register(cls):
            self._module_dict[name or cls.__name__] = cls
            return cls

        return _register


def build_from_cfg(cfg: Any, registry: Registry, **default_args) -> Any:
    """Construct from {'type': Name, **kwargs}; lists build element-wise."""
    if cfg is None:
        return None
    if isinstance(cfg, (list, tuple)):
        return [build_from_cfg(c, registry, **default_args) for c in cfg]
    if isinstance(cfg, str):
        return registry.get(cfg)(**default_args)
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with 'type', got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    for k, v in default_args.items():
        args.setdefault(k, v)
    return registry.get(obj_type)(**args)


# the seven reference registries (jnerf registry.py:48-55)
DATASETS = Registry("DATASETS")
ENCODERS = Registry("ENCODERS")
NETWORKS = Registry("NETWORKS")
SAMPLERS = Registry("SAMPLERS")
LOSSES = Registry("LOSSES")
OPTIMS = Registry("OPTIMS")
SCHEDULERS = Registry("SCHEDULERS")
