"""Checkpoint save/load: {meta, model, optimizer} as a pickle of numpy
arrays.

Port of `jdet_tpu/runner/checkpoint.py` (payload :57, atomic write
:80-83, the JDet branch :87-113). `meta` carries `jdet_torch_version`,
`save_time`, `epoch`, `iter`, `max_epoch`, `max_iter` and `config`;
`model` is the model's state_dict (buffers included) as numpy;
`optimizer` holds the count of updates made and, by parameter name, the
SGD momentum buffers (`momentum`) or Adam's moments and step count
(`adam`: `exp_avg`, `exp_avg_sq`, `step`) of the parameters it updates.

`load_checkpoint` also takes
- a `jdet_tpu` checkpoint (its meta carries `jdet_tpu_version`), as the
  reference restores it (:115-121): the nnx parameter paths, joined by
  "/", go through `models/convert.py::params_from_jax` (given the model,
  whose modules decide the layout of 4-D weights), and so does the optax
  state of the parameters the port updates: SGD's momentum,
  `opt_state/.../trace/<param path>`, and Adam's and AdamW's moments,
  `opt_state/.../mu/<param path>` and `.../nu/<param path>`. The update
  count comes from the schedule's `opt_state/.../count` leaf, or from
  `meta["iter"]` where the payload has none; Adam's chain holds a second
  count, a sibling of `mu` and `nu`, which is Adam's own step;
- a JDet (jittor) detector checkpoint (`_is_reference_payload`: a
  `jdet_version` in its meta, or torch-style `.running_mean` names, and
  no `jdet_tpu_version`), or a raw state dict, imported as the reference
  imports it (`models/pretrained.py::import_jdet_checkpoint`, not
  strict); it carries no optimizer state for the port.

A payload may carry the model EMA (`utils/ema.py`) as `ema`: {"state":
its tensors, "updates", "decay"}. The port writes the state as flat numpy
under its state-dict names; the reference writes the flax `nnx.State` of
its EMA (`jdet_tpu/runner/checkpoint.py:75-79`). A full load hands it to
the Runner as `meta["_ema_payload"]`, its state under the port's names; a
model-only load ignores it, as the reference does.

Files are read by `_CheckpointUnpickler`, which needs neither flax nor
JAX: it maps the four flax classes a reference EMA payload names
(`State`, `Param`, `BatchStat`, `TraceState`) to plain stand-ins whose
arrays are read out, takes numpy's globals and `collections.OrderedDict`,
and refuses every other global by name. Only files from trusted sources
may be loaded all the same.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from ..models.convert import params_from_jax
from ..models.pretrained import import_jdet_checkpoint

VERSION = "0.1.0"


class _FlaxStandIn:
    """What a flax `State`, `Param`, `BatchStat` or `TraceState` unpickles
    to: the attributes the pickle stores, and nothing else."""

    def __setstate__(self, state):
        if isinstance(state, tuple):  # (dict, slots)
            state = {**(state[0] or {}), **(state[1] or {})}
        self.__dict__.update(state)


_FLAX_CLASSES = {("flax.nnx.statelib", "State"), ("flax.nnx.variablelib", "Param"),
                 ("flax.nnx.variablelib", "BatchStat"), ("flax.nnx.tracers", "TraceState")}


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _FLAX_CLASSES:
            return type(name, (_FlaxStandIn,), {})
        if module == "numpy" or module.startswith("numpy.") or (
                module, name) == ("collections", "OrderedDict"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refused global {module}.{name}")


def _read_payload(path):
    with open(path, "rb") as f:
        try:
            return _CheckpointUnpickler(f).load()
        except pickle.UnpicklingError as e:
            raise pickle.UnpicklingError(f"{path}: {e}") from None


def _flax_state_flat(state, prefix=""):
    """{dotted path: array} of an unpickled flax `State` (or a nested dict
    of variables and arrays)."""
    if isinstance(state, _FlaxStandIn) and hasattr(state, "_mapping"):
        state = state._mapping
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update(_flax_state_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(state, _FlaxStandIn):
        state = state._raw_value
    return {prefix[:-1]: np.asarray(state)}


def _ema_state(ema, meta, model):
    """The EMA payload's state as {port state-dict name: tensor}."""
    state = ema["state"]
    if "jdet_tpu_version" in meta:
        return params_from_jax(_flax_state_flat(state), model)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


def save_checkpoint(path, model, optimizer=None, meta=None, ema=None):
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
        state = {name: {k: v.numpy() for k, v in st.items()}
                 for name, st in optimizer.state_by_name(model).items()}
        payload["optimizer"] = {"count": optimizer.count}
        if optimizer.kind == "sgd":
            payload["optimizer"]["momentum"] = {n: st["momentum_buffer"]
                                                for n, st in state.items() if st}
        else:
            payload["optimizer"]["adam"] = state
    if ema is not None:
        payload["ema"] = {"state": {k: v.detach().cpu().numpy() for k, v in ema.ema.items()},
                          "updates": int(ema.updates), "decay": float(ema.decay)}
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
    and "momentum" (SGD) or "adam": {parameter name: state}}. Of the
    chain's count leaves, the one beside `mu`/`nu` is Adam's step and the
    other the schedule's."""
    counts = {k[: -len("/count")]: v for k, v in opt_state.items()
              if k.startswith("opt_state/") and k.endswith("/count")}
    adam = {p for p in counts if any(k.startswith(f"{p}/mu/") for k in opt_state)}
    schedule = [v for p, v in counts.items() if p not in adam]
    if len(schedule) > 1 or len(adam) > 1:
        raise ValueError(f"optax count leaves {sorted(counts)}: expected at most one "
                         "schedule count and one Adam count")
    names = {n for n, _ in model.named_parameters()}

    def leaves(kind):
        flat = {k.split(f"/{kind}/", 1)[1].replace("/", "."): v
                for k, v in opt_state.items() if f"/{kind}/" in k}
        return {k: v.numpy() for k, v in params_from_jax(flat, model).items() if k in names}

    out = {"count": int(schedule[0]) if schedule else int(meta.get("iter", 0))}
    if adam:
        step = float(counts[adam.pop()])
        mu, nu = leaves("mu"), leaves("nu")
        out["adam"] = {n: {"exp_avg": mu[n], "exp_avg_sq": nu[n], "step": np.float32(step)}
                       for n in mu}
    else:
        out["momentum"] = leaves("trace")
    return out


def _is_reference_payload(payload):
    """A JDet (jittor) checkpoint: a `jdet_version` in its meta, or
    torch-style BN statistics names, and neither package's own version."""
    meta = payload.get("meta", {})
    if "jdet_tpu_version" in meta or "jdet_torch_version" in meta:
        return False
    if "jdet_version" in meta:
        return True
    return any(str(k).endswith((".running_mean", ".running_var")) for k in payload["model"])


def load_checkpoint(path, model, optimizer=None, model_only=False):
    """Load `path` into `model` (and `optimizer` unless model_only);
    returns the checkpoint's meta, with the EMA payload, if any, under
    `_ema_payload` unless model_only."""
    payload = _read_payload(path)
    if isinstance(payload, dict) and "model" not in payload:  # a raw state dict
        payload = {"model": payload.get("state_dict", payload), "meta": {}}
    meta = dict(payload.get("meta", {})) if isinstance(payload, dict) else {}
    if not model_only and payload.get("ema") is not None:
        ema = payload["ema"]
        meta["_ema_payload"] = {**ema, "state": _ema_state(ema, meta, model)}
    if isinstance(payload, dict) and _is_reference_payload(payload):
        import_jdet_checkpoint(model, payload)
        return meta
    opt = payload.get("optimizer") if optimizer is not None and not model_only else None
    if "jdet_tpu_version" in meta:
        flat = {k.replace("/", "."): v for k, v in payload["model"].items()}
        _load_state(model, params_from_jax(flat, model))
        if opt is not None:
            opt = _jax_optimizer_state(opt, meta, model)
    elif "jdet_torch_version" in meta:
        _load_state(model, payload["model"])
    else:
        raise ValueError(f"{path}: neither a jdet_torch, a jdet_tpu nor a JDet checkpoint")
    if opt is not None:
        if ("adam" in opt) != (optimizer.kind != "sgd"):
            raise ValueError(f"{path}: its optimizer state is not the {optimizer.kind} "
                             "optimizer's")
        optimizer.count = int(opt["count"])
        if "adam" in opt:
            optimizer.load_state_by_name(model, opt["adam"])
        else:
            optimizer.load_state_by_name(model, {n: {"momentum_buffer": v}
                                                 for n, v in opt["momentum"].items()})
    return meta
