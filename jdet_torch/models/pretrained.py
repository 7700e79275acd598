"""Weight import with no JAX: torchvision, jittor and JDet files ->
jdet_torch modules.

Port of `jdet_tpu/models/pretrained.py` into the port's state-dict names:
the reference maps a source file's names onto its flax paths and turns
OIHW into HWIO; the port's module names mirror those paths with torch's
leaf names (`weight`, `bias`, `running_mean`, `running_var`), so here the
names change only where the modules nest differently, and the tensors
keep their layout (a conv's OIHW, a depthwise (dim, 1, k, k), a linear's
(out, in)). The parts:

- `load_blob` (:91): a `.pth`/`.pt` through `torch.load`, a `.pkl`/`.bin`
  through pickle; a `state_dict` or `model` entry is unwrapped.
- `resnet_to_flat` (:122): torchvision/jittor ResNet, the plain stem or
  the v1d `C1`/`stem` Sequential, each downsample layout; `fc.` dropped.
- `reresnet_to_flat` (:209): e2cnn ReResNet; a conv's base weight from
  its `filter` buffer, or from its R2Conv basis coefficients (`.weights`)
  through `equivariant/c8_basis.py::expand_filter`, given the port
  module's shapes; `batch_norm_[8]` -> `bn`.
- `lsknet_to_flat` (:272): mmcls LSKNet/StripNet (`patch_embed{i}`,
  `block{i}`, `norm{i}` -> `patch_embeds`, `stages`, `stage_norms`;
  `spatial_gating_unit` -> `gate`; `layer_scale_{1,2}` -> `ls1`/`ls2`).
- `backbone_to_flat` (:334), `load_pretrained_backbone` (:355): a raw
  file converted on the fly, a file of `tools/convert_weights.py` (the
  JAX tool's flax paths, through `convert.params_from_jax`), or one of
  `python -m jdet_torch.tools.convert_weights` (the port's names).
- `detector_sd_to_flat` (:370), `import_jdet_checkpoint` (:442): a JDet
  detector state dict; the backbone through its family's converter, the
  FPN's extra convs, which JDet appends to `fpn_convs`, shifted into
  `extra_convs`, and a ConvModule's `.conv.` segment dropped where the
  port holds a bare conv.

- `vgg16_to_flat` (:312): torchvision vgg16 `features.N` (and mmdet
  SSDVGG's fc6 / fc7) -> SSDVGG's `blocks.<i>.<j>`, `fc6`, `fc7`.

Only files from trusted sources may be loaded: unpickling can run code.
"""
from __future__ import annotations

import os
import pickle
import re

import numpy as np
import torch

from .convert import params_from_jax

N_ORIENT = 8


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _read(path):
    if str(path).endswith((".pth", ".pt")):
        return torch.load(path, map_location="cpu", weights_only=False)
    with open(path, "rb") as f:
        return pickle.load(f)


def _unwrap(blob):
    if isinstance(blob, dict):
        for key in ("state_dict", "model"):
            if isinstance(blob.get(key), dict):
                return blob[key]
    return blob


def load_blob(path):
    """A state dict {name: np.ndarray} from a `.pth`/`.pt` (torch) or a
    `.pkl`/`.bin` (pickle) file, its `state_dict` or `model` entry if it
    has one."""
    return {k: _np(v) for k, v in _unwrap(_read(path)).items()}


def assign_state(module, mapping, strict=True, prefix=""):
    """Copy {state-dict name: array} into `module`. Returns (loaded,
    missing, unexpected) name lists: `missing` are the module's
    parameters and statistics the mapping does not cover (BN update
    counters aside), `unexpected` the mapping's names the module lacks,
    which raise under `strict`. A shape mismatch always raises."""
    state = module.state_dict()
    loaded, unexpected, new = [], [], {}
    for name, arr in mapping.items():
        cur = state.get(name)
        if cur is None:
            unexpected.append(name)
            continue
        arr = _np(arr)
        if tuple(cur.shape) != tuple(arr.shape):
            raise ValueError(f"{prefix}{name}: shape {tuple(arr.shape)} != model "
                             f"{tuple(cur.shape)}")
        new[name] = torch.as_tensor(arr, dtype=cur.dtype)
        loaded.append(name)
    missing = [n for n in state if n not in mapping and not n.endswith("num_batches_tracked")]
    if strict and unexpected:
        raise KeyError(f"{prefix}unmatched source keys: {unexpected[:8]}"
                       f" (+{max(0, len(unexpected) - 8)} more)")
    module.load_state_dict(new, strict=False)
    return loaded, missing, unexpected


# ResNet / ResNet-v1d ----------------------------------------------------------

_V1D_STEM = {0: "conv1a", 1: "bn1a", 3: "conv1b", 4: "bn1b", 6: "conv1c", 7: "bn1c"}


def resnet_to_flat(sd, deep_stem=False):
    """torchvision/jittor ResNet names -> the port's. Plain stem: conv1/bn1.
    v1d: the `C1` (or `stem`) Sequential's {0, 1, 3, 4, 6, 7} ->
    conv1a/bn1a/.../bn1c, and the downsample Sequential(pool, conv, bn)'s
    {1, 2} -> conv/bn; plain downsample (conv, bn) {0, 1} -> conv/bn."""
    out = {}
    for key, v in sd.items():
        if key.endswith("num_batches_tracked") or key.startswith("fc."):
            continue
        k = key
        if deep_stem:
            m = re.match(r"^(?:C1|stem)\.(\d+)\.(.+)$", k)
            if m:
                k = f"{_V1D_STEM[int(m.group(1))]}.{m.group(2)}"
            k = re.sub(r"\.downsample\.1\.", ".downsample.conv.", k)
            k = re.sub(r"\.downsample\.2\.", ".downsample.bn.", k)
        else:
            k = re.sub(r"\.downsample\.0\.", ".downsample.conv.", k)
            k = re.sub(r"\.downsample\.1\.", ".downsample.bn.", k)
        out[k] = _np(v)
    return out


# ReResNet (C8 regular fields) -------------------------------------------------

def _refilter_to_base(filt):
    """e2cnn expanded filter (O*8, I*8, k, k) -> the base (O, I, 8, k, k):
    expanded[o*8 + r, i*8 + s] = rot_r(base[o, i, (s - r) % 8]), so the
    r = 0 block is the base, base[o, i, s] = expanded[o*8, i*8 + s]."""
    O8, I8, k, _ = filt.shape
    f = filt.reshape(O8 // N_ORIENT, N_ORIENT, I8 // N_ORIENT, N_ORIENT, k, k)
    return np.ascontiguousarray(f[:, 0])


def _ds_rename(k):
    """ReResNet's downsample Sequential(conv1x1, norm) -> .conv/.bn."""
    return re.sub(r"\.downsample\.0\.", ".downsample.conv.",
                  re.sub(r"\.downsample\.1\.", ".downsample.bn.", k))


def _expand_r2conv_weights(key, coeff, shapes):
    """A conv's R2Conv basis coefficients (`<conv>.weights`, what a
    train-mode reference checkpoint saves) -> its e2cnn filter, through
    the exact C8 basis; `shapes` (the port module's state-dict shapes)
    give the conv's fields, kernel size and kind."""
    from .equivariant.c8_basis import expand_filter

    base = key[: -len(".weights")]
    ours = _ds_rename(f"{base}.weight")
    shape = shapes.get(ours)
    if shape is None:
        raise KeyError(f"{key}: basis-coefficient conv has no target param {ours}")
    if len(shape) == 5:  # regular REConv2d (O, I, 8, k, k)
        of, infl, _, k, _ = shape
        return expand_filter(coeff, int(k), out_fields=int(of), in_fields=int(infl),
                             in_kind="regular")
    of, in_ch, k, _ = shape  # the lifting stem (O, in_ch, k, k)
    return expand_filter(coeff, int(k), out_fields=int(of), in_fields=int(in_ch),
                         in_kind="trivial")


def reresnet_to_flat(sd, shapes=None):
    """ReResNet names -> the port's. A conv's base weight comes from its
    `filter` buffer (any eval() pass fills it), or where that is missing
    or all zero, from its basis coefficients, which needs the target
    `shapes` (`backbone_to_flat` passes them)."""
    filters = {}
    for key, v in sd.items():
        if key.endswith(".filter"):
            filt = _np(v)
            if np.any(filt):
                filters[key[: -len(".filter")]] = filt
    for key, v in sd.items():
        if key.endswith(".weights"):
            base = key[: -len(".weights")]
            if base in filters:
                continue
            if shapes is None:
                raise ValueError(
                    f"{key}: checkpoint has basis coefficients but no materialized filter, "
                    "and no target shapes were given: convert through "
                    "load_pretrained_backbone or backbone_to_flat(backbone, sd)")
            filters[base] = _expand_r2conv_weights(key, _np(v), shapes)

    out = {}
    for key in list(sd) + [f"{b}.filter" for b in filters if f"{b}.filter" not in sd]:
        if key.endswith(".filter"):
            base = key[: -len(".filter")]
            filt = filters.get(base)
            if filt is None:
                raise ValueError(
                    f"{key}: filter buffer is all-zero and no basis coefficients are "
                    "present: re-save the reference checkpoint after one eval() pass")
            if filt.shape[1] % N_ORIENT:  # the lifting conv (trivial input)
                w = filt.reshape(filt.shape[0] // N_ORIENT, N_ORIENT, *filt.shape[1:])
                out[f"{base}.weight"] = np.ascontiguousarray(w[:, 0])
            else:
                out[f"{base}.weight"] = _refilter_to_base(filt)
        elif ".batch_norm_[8]." in key:
            pre, post = key.split(".batch_norm_[8].")
            if post != "num_batches_tracked":
                out[f"{pre}.bn.{post}"] = _np(sd[key])
        # index buffers: regenerated
    return {_ds_rename(k): v for k, v in out.items()}


# LSKNet / StripNet -------------------------------------------------------------

def lsknet_to_flat(sd):
    """mmcls LSKNet/StripNet names -> the port's (`patch_embeds`, `stages`,
    `stage_norms` lists); the classifier `head.` is dropped."""
    out = {}
    for key, v in sd.items():
        if key.endswith("num_batches_tracked") or key.startswith("head."):
            continue
        k = re.sub(r"^patch_embed(\d)\.", lambda m: f"patch_embeds.{int(m.group(1)) - 1}.", key)
        k = re.sub(r"^block(\d)\.", lambda m: f"stages.{int(m.group(1)) - 1}.", k)
        k = re.sub(r"^norm(\d)\.", lambda m: f"stage_norms.{int(m.group(1)) - 1}.", k)
        k = k.replace(".spatial_gating_unit.", ".gate.")
        k = k.replace(".mlp.dwconv.dwconv.", ".mlp.dwconv.")
        k = k.replace(".layer_scale_1", ".ls1").replace(".layer_scale_2", ".ls2")
        out[k] = _np(v)
    return out


# VGG16 (SSD) -----------------------------------------------------------------

# torchvision's `features.N` conv index -> (block, conv) of SSDVGG
VGG16_CONV_IDX = [(0, 0, 0), (2, 0, 1), (5, 1, 0), (7, 1, 1),
                  (10, 2, 0), (12, 2, 1), (14, 2, 2),
                  (17, 3, 0), (19, 3, 1), (21, 3, 2),
                  (24, 4, 0), (26, 4, 1), (28, 4, 2)]


def vgg16_to_flat(sd):
    """torchvision vgg16 `features.N` convs (and mmdet SSDVGG's fc6 / fc7 at
    `features.31` / `features.33`, where present) -> SSDVGG's names."""
    out = {}
    for feat_i, b, j in VGG16_CONV_IDX:
        if f"features.{feat_i}.weight" in sd:
            out[f"blocks.{b}.{j}.weight"] = _np(sd[f"features.{feat_i}.weight"])
            out[f"blocks.{b}.{j}.bias"] = _np(sd[f"features.{feat_i}.bias"])
    for feat_i, name in ((31, "fc6"), (33, "fc7")):
        if f"features.{feat_i}.weight" in sd:
            out[f"{name}.weight"] = _np(sd[f"features.{feat_i}.weight"])
            out[f"{name}.bias"] = _np(sd[f"features.{feat_i}.bias"])
    return out


# dispatch and detectors ------------------------------------------------------

def backbone_to_flat(backbone, sd):
    """The converter of the backbone's family."""
    name = type(backbone).__name__
    if name == "ReResNet":
        shapes = {k: tuple(v.shape) for k, v in backbone.state_dict().items()}
        return reresnet_to_flat(sd, shapes=shapes)
    if name in ("LSKNet", "StripNet"):
        return lsknet_to_flat(sd)
    if name == "SSDVGG":
        return vgg16_to_flat(sd)
    if name in ("ResNet", "ResNet_v1d"):
        return resnet_to_flat(sd, deep_stem=getattr(backbone, "deep_stem", False))
    raise ValueError(f"no pretrained converter for backbone {name}")


def _is_flax_naming(state):
    return any(str(k).endswith(("/kernel", "/scale", ".kernel", ".scale")) for k in state)


def load_pretrained_backbone(backbone, path, strict=False):
    """Load `backbone.pretrained` into `backbone`: a torchvision or jittor
    ImageNet state dict (converted here), a file of the JAX package's
    `tools/convert_weights.py` (flax paths, '/' or '.' separated), or one
    of `python -m jdet_torch.tools.convert_weights` (the port's names).
    Returns (loaded, missing, unexpected), as `assign_state`."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"backbone.pretrained={path!r} not found. Convert ImageNet weights with "
            "`python -m jdet_torch.tools.convert_weights --family <fam> --src <weights> "
            f"--out {path}`, pass the .pth/.pkl itself, or build with load_pretrained=False.")
    blob = _read(path)
    meta = blob.get("meta", {}) if isinstance(blob, dict) else {}
    state = _unwrap(blob)
    if "jdet_torch_version" in meta:
        mapping = state
    elif "jdet_tpu_version" in meta or _is_flax_naming(state):
        mapping = params_from_jax({k.replace("/", "."): _np(v) for k, v in state.items()},
                                  backbone)
    else:
        mapping = backbone_to_flat(backbone, {k: _np(v) for k, v in state.items()})
    return assign_state(backbone, mapping, strict=strict, prefix=f"{type(backbone).__name__}: ")


def detector_sd_to_flat(model, sd):
    """A JDet detector state dict (backbone./neck./rpn_head./bbox_head.
    prefixes) -> the port's names: the backbone through its family's
    converter, the rest as named, but for the FPN's extra convs (JDet's
    `fpn_convs` past the port's go to `extra_convs`) and a ConvModule's
    `.conv.` segment where the port holds a bare conv."""
    groups = {}
    for key, v in sd.items():
        if "." in key:
            head, rest = key.split(".", 1)
            groups.setdefault(head, {})[rest] = v
    names = set(model.state_dict())
    out = {}
    if "backbone" in groups and hasattr(model, "backbone"):
        for k, arr in backbone_to_flat(model.backbone, groups.pop("backbone")).items():
            out[f"backbone.{k}"] = arr
    neck = getattr(model, "neck", None)
    n_fpn = len(neck.fpn_convs) if neck is not None and hasattr(neck, "fpn_convs") else None
    for head, sub in groups.items():
        for key, v in sub.items():
            if key.endswith("num_batches_tracked"):
                continue
            k = key
            if head == "neck" and n_fpn is not None:
                m = re.match(r"^fpn_convs\.(\d+)\.(.+)$", k)
                if m and int(m.group(1)) >= n_fpn:
                    k = f"extra_convs.{int(m.group(1)) - n_fpn}.{m.group(2)}"
            full = f"{head}.{k}"
            if full not in names:
                alt = full.replace(".conv.weight", ".weight").replace(".conv.bias", ".bias")
                if alt in names:
                    full = alt
            out[full] = _np(v)
    return out


def import_jdet_checkpoint(model, path_or_payload, strict=False):
    """Import a JDet detector checkpoint ({"meta", "model", ...}, a file
    or the loaded payload) into `model`. Returns (loaded, missing,
    unexpected), as `assign_state`."""
    if isinstance(path_or_payload, (str, bytes, os.PathLike)):
        sd = load_blob(path_or_payload)
    else:
        payload = path_or_payload
        sd = payload.get("model", payload.get("state_dict", payload))
        sd = {k: _np(v) for k, v in sd.items()}
    return assign_state(model, detector_sd_to_flat(model, sd), strict=strict,
                        prefix="detector: ")
