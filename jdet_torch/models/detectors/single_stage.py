"""Single-stage detector: backbone -> neck -> head.

Port of `jdet_tpu/models/detectors/single_stage.py`
(`SingleStageDetector` :16, `RotatedRetinaNet` :51, `S2ANet` :56, `FCOS`
:61, `KnowledgeDistillationSingleStageDetector` :66, `RotatedRepPoints` :98,
`SSD` :104, `R3Det` :110). Images come in as
(B, H, W, 3) NHWC float32, the reference's batch contract, and are
permuted to NCHW once here.
"""
from __future__ import annotations

import torch
from torch import nn

from ...utils.registry import MODELS


@MODELS.register_module()
class SingleStageDetector(nn.Module):
    def __init__(self, backbone, neck=None, bbox_head=None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head

    def extract_feat(self, images):
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        if self.neck is not None:
            feats = self.neck(feats)
        return feats

    def loss(self, images, targets, generator=None):
        """Training forward: images (B, H, W, 3), targets dict with
        gt_bboxes / gt_labels / gt_mask. Returns dict of scalar losses.
        `generator` (the train step's) is unused: nothing here draws."""
        return self.bbox_head.loss(self.bbox_head(self.extract_feat(images)), targets)

    @torch.no_grad()
    def predict(self, images, targets=None):
        return self.bbox_head.predict(
            self.bbox_head(self.extract_feat(images)), targets
        )


@MODELS.register_module()
class RotatedRetinaNet(SingleStageDetector):
    """Thin wrapper; all logic lives in the head."""


@MODELS.register_module()
class S2ANet(SingleStageDetector):
    """Thin wrapper; all logic lives in `S2ANetHead`."""


@MODELS.register_module()
class FCOS(SingleStageDetector):
    """Thin wrapper; all logic lives in `FCOSHead`."""


@MODELS.register_module()
class RotatedRepPoints(SingleStageDetector):
    """Thin wrapper; all logic lives in `RotatedRepPointsHead`."""


@MODELS.register_module()
class SSD(SingleStageDetector):
    """Thin wrapper; all logic lives in `SSDHead`."""


@MODELS.register_module()
class R3Det(SingleStageDetector):
    """Thin wrapper; all logic lives in `R3DetHead`."""


@MODELS.register_module()
class KnowledgeDistillationSingleStageDetector(SingleStageDetector):
    """Localization distillation: a frozen teacher detector, built from its
    own config (and, with `teacher_ckpt`, loaded model-only from a
    checkpoint), gives the student head's `loss_with_teacher` its box
    distributions. The teacher runs on its running statistics under
    `torch.no_grad()`, and stays in eval mode whatever `train()` sets (the
    reference calls it with train=False); `build_optimizer` leaves every
    parameter under `teacher` out of the updates."""

    def __init__(self, backbone, neck=None, bbox_head=None, teacher=None, teacher_ckpt=None):
        super().__init__(backbone, neck, bbox_head)
        self.teacher = teacher
        if teacher is not None and teacher_ckpt:
            from ...runner.checkpoint import load_checkpoint

            load_checkpoint(teacher_ckpt, self.teacher, model_only=True)
        self.train(self.training)

    def train(self, mode=True):
        super().train(mode)
        if self.teacher is not None:
            self.teacher.eval()
        return self

    def loss(self, images, targets, generator=None):
        outs = self.bbox_head(self.extract_feat(images))
        if self.teacher is None:
            return self.bbox_head.loss(outs, targets)
        with torch.no_grad():
            t_outs = self.teacher.bbox_head(self.teacher.extract_feat(images))
        return self.bbox_head.loss_with_teacher(outs, t_outs, targets)
