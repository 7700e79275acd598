"""Checkpoint save/load: {meta, model, optimizer} as a pickle of numpy
arrays.

Port of `jdet_tpu/runner/checkpoint.py` (payload :57, atomic write
:80-83). `meta` carries `jdet_torch_version`, `save_time`, `epoch`,
`iter`, `max_epoch`, `max_iter` and `config`; `model` is the model's
state_dict (buffers included) as numpy; `optimizer` holds the SGD
momentum buffers by parameter name and the count of updates made.

`load_checkpoint` also takes a `jdet_tpu` checkpoint (its meta carries
`jdet_tpu_version`), as the reference restores it (:115-121): the nnx
parameter paths, joined by "/", go through
`models/convert.py::params_from_jax` (given the model, whose modules
decide the layout of 4-D weights), and so does the optax momentum,
`opt_state/.../trace/<param path>`, into the SGD momentum buffers of the
parameters SGD updates (the frozen ones keep none, as in the port's own
checkpoints); the update count comes from the schedule's
`opt_state/.../count` leaf, or from `meta["iter"]` where the payload has
none. A full load of a payload with an `ema` entry raises until EMA is
ported; a model-only load ignores it, as the reference does. Only files
this repository wrote may be loaded: unpickling can run code.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from ..models.convert import params_from_jax

VERSION = "0.1.0"


def save_checkpoint(path, model, optimizer=None, meta=None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "meta": {
            "jdet_torch_version": VERSION,
            "save_time": time.strftime("%Y-%m-%d %H:%M:%S"),
            **(meta or {}),
        },
        "model": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
    }
    if optimizer is not None:
        state = optimizer.sgd.state
        payload["optimizer"] = {
            "count": optimizer.count,
            "momentum": {
                name: state[p]["momentum_buffer"].detach().cpu().numpy()
                for name, p in model.named_parameters()
                if state.get(p, {}).get("momentum_buffer") is not None
            },
        }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)
    return path


def _load_state(model, state):
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
                          strict=True)


def _jax_optimizer_state(opt_state, meta, model):
    """A `jdet_tpu` optimizer payload -> the port's {"count": updates made,
    "momentum": {parameter name: buffer}}."""
    counts = [v for k, v in opt_state.items() if k.startswith("opt_state/") and k.endswith("/count")]
    if len(counts) > 1:
        raise ValueError(f"{len(counts)} optax count leaves; expected at most one")
    traces = {k.split("/trace/", 1)[1].replace("/", "."): v
              for k, v in opt_state.items() if "/trace/" in k}
    return {"count": int(counts[0]) if counts else int(meta.get("iter", 0)),
            "momentum": params_from_jax(traces, model)}


def load_checkpoint(path, model, optimizer=None, model_only=False):
    """Load `path` into `model` (and `optimizer` unless model_only);
    returns the checkpoint's meta."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    meta = dict(payload.get("meta", {})) if isinstance(payload, dict) else {}
    if not model_only and "ema" in payload:
        raise NotImplementedError(f"{path}: EMA checkpoints wait for the port of EMA")
    opt = payload.get("optimizer") if optimizer is not None and not model_only else None
    if "jdet_tpu_version" in meta:
        flat = {k.replace("/", "."): v for k, v in payload["model"].items()}
        _load_state(model, params_from_jax(flat, model))
        if opt is not None:
            opt = _jax_optimizer_state(opt, meta, model)
    elif "jdet_torch_version" in meta:
        _load_state(model, payload["model"])
    else:
        raise ValueError(f"{path}: neither a jdet_torch nor a jdet_tpu checkpoint")
    if opt is not None:
        optimizer.count = int(opt["count"])
        updated = {p for g in optimizer.sgd.param_groups for p in g["params"]}
        for name, p in model.named_parameters():
            if p in updated and name in opt["momentum"]:
                optimizer.sgd.state[p]["momentum_buffer"] = torch.as_tensor(
                    np.asarray(opt["momentum"][name]), device=p.device).clone()
    return meta
