"""Detection losses, and the `LOSSES` registry.

As in `jdet_tpu/models/losses/__init__.py` (:25-64), the losses are plain
functions: `LOSSES` maps the reference's class names to them, and
`build_from_cfg(dict(type="FocalLoss", gamma=2.0), LOSSES)` returns the
function with those keywords bound. The names whose losses are not ported
yet (`PolyIoULoss`, `PolyGIoULoss` and `ConvexGIoULoss` with
`ops/convex.py`) are not registered.
"""
from functools import partial as _partial

from ...utils.registry import LOSSES as _LOSSES
from .basic import (
    binary_cross_entropy_loss,
    cross_entropy_loss,
    l1_loss,
    sigmoid_focal_loss,
    smooth_l1_loss,
    weight_reduce_loss,
)
from .gaussian_dist_loss import bcd_loss, gaussian_dist_loss, gwd_loss, kld_loss
from .iou_loss import rotated_iou_loss
from .kf_iou_loss import kf_iou_loss
from .misc_losses import (
    im_loss,
    jd_loss,
    kld_symmax_loss,
    kld_symmin_loss,
    knowledge_distillation_kl_div_loss,
    rsdet_loss,
)
from .ridet_loss import ridet_loss
from .smooth_focal_loss import smooth_focal_loss


def _register_fn(name, fn):
    _LOSSES.register_module(name=name)(lambda **cfg: _partial(fn, **cfg) if cfg else fn)


for _name, _fn in {
    "FocalLoss": sigmoid_focal_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "L1Loss": l1_loss,
    "CrossEntropyLoss": cross_entropy_loss,
    "CrossEntropyLossForRcnn": cross_entropy_loss,
    "BCEWithLogitsLoss": binary_cross_entropy_loss,
    "SmoothFocalLoss": smooth_focal_loss,
    "GDLoss": gaussian_dist_loss,
    "GDLoss_v1": gaussian_dist_loss,
    "KFLoss": kf_iou_loss,
    "IoULoss": rotated_iou_loss,
    "KnowledgeDistillationKLDivLoss": knowledge_distillation_kl_div_loss,
    "IMLoss": im_loss,
    "RSDetLoss": rsdet_loss,
    "RIDetLoss": ridet_loss,
}.items():
    _register_fn(_name, _fn)
