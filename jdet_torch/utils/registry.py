"""Name -> class registries + config-driven builder.

Copy of `jdet_tpu/utils/registry.py` (`Registry` :13, `build_from_cfg`
:45), kept in the port so that it imports nothing of the JAX package.
"""
from __future__ import annotations


class Registry:
    def __init__(self, name):
        self.name = name
        self._modules = {}

    def register_module(self, cls=None, name=None):
        def _register(c):
            key = name or c.__name__
            if key in self._modules:
                raise KeyError(f"{key} already registered in {self.name}")
            self._modules[key] = c
            return c

        if cls is not None:
            return _register(cls)
        return _register

    def get(self, key):
        if key not in self._modules:
            raise KeyError(
                f"{key} not registered in {self.name}; "
                f"known: {sorted(self._modules)}"
            )
        return self._modules[key]


def build_from_cfg(cfg, registry, **default_kwargs):
    """Build an object from config.

    str -> no-arg construction; dict -> pop `type`, rest are kwargs merged
    over `default_kwargs`; list -> list of built objects; None -> None.
    """
    if cfg is None:
        return None
    if isinstance(cfg, str):
        return registry.get(cfg)(**default_kwargs)
    if isinstance(cfg, (list, tuple)):
        return [build_from_cfg(c, registry, **default_kwargs) for c in cfg]
    if isinstance(cfg, dict):
        args = dict(cfg)
        obj_type = args.pop("type")
        kwargs = {**default_kwargs, **args}
        return registry.get(obj_type)(**kwargs)
    raise TypeError(f"cannot build from {type(cfg)}")


MODELS = Registry("MODELS")
BACKBONES = Registry("BACKBONES")
NECKS = Registry("NECKS")
HEADS = Registry("HEADS")
DATASETS = Registry("DATASETS")
TRANSFORMS = Registry("TRANSFORMS")
LOSSES = Registry("LOSSES")
