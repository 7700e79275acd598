"""`.py` config loader with recursive `_base_` merging.

Copy of the `.py` branch of `jdet_tpu/config/config.py` (`_load_py_dict`
:67, `merge_dict_b2a` :94, `load_cfg_file` :124): a config module's
non-dunder globals become the dict, `_base_` names parent files merged in
order, and a child dict carrying `_cover_: True` replaces the parent
subtree instead of merging into it.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import types


def _load_py_dict(filename):
    """Execute a .py config module; non-dunder globals become the dict."""
    name = "_jdet_torch_cfg_" + os.path.basename(filename).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, filename)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
        out = {
            k: v
            for k, v in vars(mod).items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
        }
    finally:
        sys.modules.pop(name, None)
    return out


def merge_dict_b2a(a, b):
    """Merge child dict b over parent dict a, in place on a."""
    for k, v in b.items():
        if k == "_cover_":
            continue
        if (
            k in a
            and isinstance(a[k], dict)
            and isinstance(v, dict)
            and not v.get("_cover_", False)
        ):
            merge_dict_b2a(a[k], v)
        else:
            a[k] = _strip_cover(v)
    return a


def _strip_cover(v):
    if isinstance(v, dict):
        return {k: _strip_cover(x) for k, x in v.items() if k != "_cover_"}
    if isinstance(v, (list, tuple)):
        return type(v)(_strip_cover(x) for x in v)
    return v


def load_cfg_file(filename):
    """Load one `.py` config file, resolving its `_base_` chain."""
    filename = os.path.abspath(filename)
    if not filename.endswith(".py"):
        raise ValueError(f"unsupported config type: {filename}")
    raw = _load_py_dict(filename)
    bases = raw.pop("_base_", None)
    if bases is None:
        return _strip_cover(raw)
    if isinstance(bases, str):
        bases = [bases]
    merged = {}
    for b in bases:
        base_file = b if os.path.isabs(b) else os.path.join(
            os.path.dirname(filename), b
        )
        merge_dict_b2a(merged, load_cfg_file(base_file))
    merge_dict_b2a(merged, raw)
    return merged
