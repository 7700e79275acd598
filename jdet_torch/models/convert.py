"""Weight bridge: parameters of the JAX model -> a torch state_dict.

The input is keyed by the JAX model's flat parameter paths, as
`jdet_tpu.models.pretrained.flat_paths` (`pretrained.py:47`) produces
them, with numpy arrays as values. The port's module attribute names
mirror those paths, so the mapping is mechanical:

  <p>.kernel (H, W, I, O)   -> <p>.weight (O, I, H, W)   (inverse of conv_w)
  <p>.kernel (I, O)         -> <p>.weight (O, I)         (Linear)
  <p>.bias                  -> <p>.bias
  <p>.scale / .mean / .var  -> <p>.weight / .running_mean / .running_var
                               (+ <p>.num_batches_tracked = 0 where <p> is a
                               BatchNorm; a LayerNorm's or a GroupNorm's
                               scale is its weight)
  <p>.scale (0-d)           -> <p>.scale                 (FCOS's `Scale`)
  <p>.ls1 / <p>.ls2         -> as they are (LSKNet's layer scales)
  <p>.weight (C,)           -> <p>.weight                (SSD's L2Norm)
  <p>.weight (H, W, I, O)   -> <p>.weight (O, I, H, W)   (DeformConv)
  <p>.weight (O, I, k, k)   -> <p>.weight as it is        (REConv2dLift)
  <p>.weight (O, I, nOr, k, k) -> <p>.weight as it is      (ORConv2d, REConv2d)
  <p>.bn.scale / .mean / .var -> <p>.bn.weight / ...       (InnerBatchNorm's
                               BatchNorm child, by the BN rule above)
  <p>.wexp, <p>._src        -> skipped: the expanded-weight cache of
                               ORConv2d and the C8 convs, a non-parameter
                               of shape (0,), and their static ARF gather
                               table, which the port builds itself
                               (`ops/orn.py::arf_gather_indices`)

A 4-D `weight` is a DeformConv's HWIO kernel or a lifting conv's OIHW
one, and a `scale` a BatchNorm's or a LayerNorm's: the rule is the
module's, so `params_from_jax(flat, model)` takes `model`, the module the
parameters are for. Weight files of torchvision, jittor and JDet are
imported by `models/pretrained.py`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.deform_conv import DeformConv
from .backbones.ssd_vgg import L2Norm
from .equivariant.econv import REConv2dLift
from .layers import Scale

_BN_RENAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _weight_4d(model, path, prefix, arr):
    """A 4-D `weight` leaf in the layout of the module it belongs to."""
    module = model.get_submodule(prefix)
    if isinstance(module, DeformConv):
        return arr.transpose(3, 2, 0, 1)
    if isinstance(module, REConv2dLift):
        return arr
    raise KeyError(f"{path}: no 4-D weight rule for {type(module).__name__}")


def params_from_jax(flat, model):
    """{jax flat path: np.ndarray} -> torch state_dict (CPU tensors).
    `model`, the module the parameters are for, decides the layout of 4-D
    `weight` leaves."""
    sd = {}
    for path, arr in flat.items():
        prefix, _, leaf = path.rpartition(".")
        arr = np.asarray(arr)
        if leaf == "kernel":
            if arr.ndim not in (2, 4):
                raise ValueError(f"{path}: expected an HWIO conv or an (I, O) linear "
                                 f"kernel, got {arr.shape}")
            sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(
                arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)))
        elif leaf == "scale" and isinstance(model.get_submodule(prefix), Scale):
            sd[path] = torch.from_numpy(np.array(arr))
        elif leaf in _BN_RENAMES:
            sd[f"{prefix}.{_BN_RENAMES[leaf]}"] = torch.from_numpy(arr.copy())
            if leaf == "scale" and isinstance(model.get_submodule(prefix), nn.BatchNorm2d):
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
        elif leaf in ("bias", "ls1", "ls2"):
            sd[path] = torch.from_numpy(arr.copy())
        elif leaf == "weight" and arr.ndim == 1 and isinstance(
                model.get_submodule(prefix), L2Norm):
            sd[path] = torch.from_numpy(arr.copy())
        elif leaf == "weight" and arr.ndim == 4:
            sd[path] = torch.from_numpy(np.array(_weight_4d(model, path, prefix, arr)))
        elif leaf == "weight" and arr.ndim == 5:
            sd[path] = torch.from_numpy(arr.copy())
        elif leaf in ("wexp", "_src"):
            continue
        else:
            raise KeyError(f"{path}: no torch counterpart for '{leaf}'")
    return sd


def load_from_jax(module, flat):
    """Strictly load JAX flat parameters into `module`: raises on any
    missing or unexpected key, or a shape mismatch."""
    module.load_state_dict(params_from_jax(flat, module), strict=True)
    return module
