"""Oriented R-CNN's second stage: rotated RoI align, two shared FCs, and
the class and box FCs.

Port of `jdet_tpu/models/heads/oriented_head.py::OrientedHead` (:49), on
the shared machinery of `roi_head_base.py`:

- `_sample_rois` (`RoIHeadBase`, rotated): each image's gts prepended to
  its proposals, the fused assigner on the per-image proposals with
  per-image masks (0.5 / 0.5 / 0.5, no low-quality match), one launch
  for the batch on the card, and the random sampler;
- `_forward_rois`: (B, S, 7, 7, C) features flattened in (y, x, c) order
  -> 1024 -> 1024 (ReLU) -> `fc_cls` (classes + background, last) and
  `fc_reg` (5 deltas, class-agnostic), cast to float32.
- `loss`: softmax cross entropy over the sampled RoIs and smooth-L1
  (beta 1) on the positives' `rbox2delta` targets (stds 0.1, 0.1, 0.2,
  0.2, 0.1), both averaged over the sampled count of the batch.
- `predict`: softmax scores of the foreground classes, `delta2rbox` from
  the proposals, and `_final_nms`.
"""
from __future__ import annotations

import torch

from ...ops.box_convert import delta2rbox, rbox2delta
from ...utils.registry import HEADS
from ..layers import Linear, normal_init
from ..losses import cross_entropy_loss, smooth_l1_loss
from .roi_head_base import RoIHeadBase


@HEADS.register_module()
class OrientedHead(RoIHeadBase):
    start_bbox_type = "obb"

    def __init__(
        self,
        num_classes=15,
        in_channels=256,
        fc_out_channels=1024,
        num_shared_fcs=2,
        roi_size=7,
        featmap_strides=(4, 8, 16, 32),
        target_means=(0.0,) * 5,
        target_stds=(0.1, 0.1, 0.2, 0.2, 0.1),
        reg_class_agnostic=True,
        extend_factor=(1.0, 1.0),
        train_cfg=None,
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        if not reg_class_agnostic:
            raise NotImplementedError("class-specific box regression is not ported")
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self._init_common(num_classes, in_channels, fc_out_channels, num_shared_fcs, roi_size,
                          featmap_strides, train_cfg, test_cfg, extend_factor, generator)
        self.fc_cls = Linear(fc_out_channels, num_classes + 1, kernel_init=normal_init(0.01),
                             generator=generator)
        self.fc_reg = Linear(fc_out_channels, 5, kernel_init=normal_init(0.001),
                             generator=generator)

    def _encode(self, rois, gts):
        return rbox2delta(rois, gts, self.target_means, self.target_stds)

    def _forward_rois(self, feats, rois, valid):
        x = self.roi_extractor(feats, rois, valid)  # (B, S, P, P, C)
        x = x.reshape(*x.shape[:2], -1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()

    def loss(self, feats, proposals, targets, rand=None, generator=None):
        """The RoI losses on the RPN's (detached) proposals. The sampler
        draws from `rand` or `generator`."""
        rois, valid, labels, lw, bt, bw, _ = self._sample_rois(
            proposals["boxes"], proposals["valid"], targets["gt_bboxes"].float(),
            targets["gt_mask"].bool(), targets["gt_labels"], rand=rand, generator=generator)
        cls_score, bbox_pred = self._forward_rois(feats, rois, valid)
        avg = (lw > 0).sum().clamp(min=1).to(cls_score.dtype)
        loss_cls = cross_entropy_loss(cls_score, labels, weight=lw, avg_factor=avg)
        loss_bbox = smooth_l1_loss(bbox_pred, bt, weight=bw, beta=1.0, avg_factor=avg)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}

    @torch.no_grad()
    def predict(self, feats, proposals, targets=None):
        rois, valid = proposals["boxes"], proposals["valid"]
        cls_score, bbox_pred = self._forward_rois(feats, rois, valid)
        scores = torch.softmax(cls_score, -1)[..., :self.num_classes] * valid[..., None]
        boxes = delta2rbox(rois, bbox_pred, self.target_means, self.target_stds)
        return self._final_nms(boxes, scores, targets)
