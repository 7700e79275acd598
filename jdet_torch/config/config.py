"""`.py` and YAML config loader with recursive `_base_` merging, and the
global config.

Copy of `jdet_tpu/config/config.py` (`_load_py_dict` :67, `_load_raw`
:85, `merge_dict_b2a` :94, `load_cfg_file` :124, `print_cfg` :182; YAML
through a lazy PyYAML import): a config module's
non-dunder globals become the dict, `_base_` names parent files merged in
order, and a child dict carrying `_cover_: True` replaces the parent
subtree instead of merging into it. `init_cfg`, `get_cfg`, `update_cfg`
and `save_cfg` (:146-180) keep one config per process, as plain dicts:
readers use `.get`.
"""
from __future__ import annotations

import importlib.util
import json
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


def _load_raw(filename):
    """One config file's own dict: a `.py` file's top-level names, or a
    `.yml` / `.yaml` file through PyYAML (the reference's `_load_raw`,
    :85-91), imported only here: a machine without PyYAML (the GPU
    machine has none) raises naming the file."""
    if filename.endswith((".yml", ".yaml")):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"{filename}: a YAML config needs PyYAML, which is not "
                              f"installed; write the config as a .py file") from e
        with open(filename) as f:
            return yaml.safe_load(f) or {}
    if filename.endswith(".py"):
        return _load_py_dict(filename)
    raise ValueError(f"unsupported config type: {filename}")


def load_cfg_file(filename):
    """Load one `.py` or YAML config file, resolving its `_base_` chain
    (whose files may be of either kind)."""
    filename = os.path.abspath(filename)
    raw = _load_raw(filename)
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


_cfg = {}


def init_cfg(filename=None):
    """Load `filename` as the global config, with `name` defaulting to the
    file's stem and `work_dir` to exp/<name> (config.py:146-160)."""
    global _cfg
    _cfg = {}
    if filename is None:
        return _cfg
    _cfg = load_cfg_file(filename)
    if _cfg.get("name") is None:
        _cfg["name"] = os.path.splitext(os.path.basename(filename))[0]
    if _cfg.get("work_dir") is None:
        _cfg["work_dir"] = os.path.join("exp", _cfg["name"])
    return _cfg


def get_cfg():
    return _cfg


def update_cfg(**kw):
    _cfg.update(kw)
    return _cfg


def print_cfg():
    """Print the global config as YAML, as the reference does (tuples as
    lists); as JSON where PyYAML is missing."""
    cfg = get_cfg()

    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v

    try:
        import yaml
    except ImportError:
        print(json.dumps(plain(cfg), indent=2, sort_keys=True, default=repr))
        return
    print(yaml.safe_dump(plain(cfg), default_flow_style=False))


def save_cfg(path=None, cfg=None):
    """Write `cfg` (the global config by default) as JSON, to
    work_dir/config.json by default. The reference writes config.yaml;
    the GPU machine has no PyYAML, so the port writes JSON. Values JSON
    cannot hold (tuples become lists) are written as their repr."""
    cfg = get_cfg() if cfg is None else cfg
    if path is None:
        os.makedirs(cfg["work_dir"], exist_ok=True)
        path = os.path.join(cfg["work_dir"], "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True, default=repr)
    return path
