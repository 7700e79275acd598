"""Config-driven model construction.

Port of `jdet_tpu/models/builder.py::build_detector` (:22-94) for
single-stage and two-stage detectors: {type, backbone{type, ...},
neck{...}, [rpn_head{...},] bbox_head{...}} assembled through the
registries, a detector without a backbone (YOLO: {type, nc, imgsz, ...})
built from its own keys, and a distillation detector's `teacher{...}` (built after
the student from the same stream, :79-88) with its `teacher_ckpt`;
weights drawn from one seeded `torch.Generator` on the CPU, then moved
to `device`. Its layers
bind the compute dtype in force while it builds (`models/nn.py`): build
inside `compute_dtype_scope(torch.bfloat16)` for the bf16 model.
"""
from __future__ import annotations

import torch

from ..utils.registry import BACKBONES, HEADS, MODELS, NECKS, build_from_cfg
from .pretrained import load_pretrained_backbone

# imports for registration side effects
from . import backbones as _backbones  # noqa: F401
from . import detectors as _detectors  # noqa: F401
from . import heads as _heads  # noqa: F401
from . import necks as _necks  # noqa: F401


def build_detector(cfg, device="cuda", seed=0, load_pretrained=True):
    """Build a detector from a model config dict on `device`.

    load_pretrained=False skips `backbone.pretrained` (random weights from
    `seed`). The default device is the card: it raises where CUDA is
    missing instead of quietly running on the CPU; pass device="cpu" to
    run there.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_detector: device 'cuda' requested but CUDA is not "
            "available; pass device='cpu' to build on the CPU"
        )
    return _build(cfg, torch.Generator().manual_seed(seed), load_pretrained).to(device)


def _build(cfg, generator, load_pretrained):
    cfg = dict(cfg)
    if "backbone" not in cfg:  # a whole network of its own (YOLO)
        return build_from_cfg(cfg, MODELS, generator=generator)
    bcfg = dict(cfg.pop("backbone"))
    pretrained = bcfg.pop("pretrained", None)
    backbone = build_from_cfg(bcfg, BACKBONES, generator=generator)
    if pretrained and load_pretrained:
        load_pretrained_backbone(backbone, pretrained)
    neck = build_from_cfg(cfg.pop("neck", None), NECKS, generator=generator,
                          in_channels=backbone.out_channels)
    parts = {}
    for key in ("rpn_head", "bbox_head"):
        hcfg = cfg.pop(key, None)
        if hcfg is not None:
            parts[key] = build_from_cfg(hcfg, HEADS, generator=generator)
    if cfg.get("teacher") is not None:
        parts["teacher"] = _build(cfg.pop("teacher"), generator, load_pretrained)
    else:
        cfg.pop("teacher", None)
        cfg.pop("teacher_ckpt", None)
    return build_from_cfg(cfg, MODELS, backbone=backbone, neck=neck, **parts)
