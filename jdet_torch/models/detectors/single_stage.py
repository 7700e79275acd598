"""Single-stage detector: backbone -> neck -> head.

Port of `jdet_tpu/models/detectors/single_stage.py`
(`SingleStageDetector` :16, `RotatedRetinaNet` :51, `S2ANet` :56). Images
come in as (B, H, W, 3) NHWC float32, the reference's batch contract, and are
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
