"""Oriented R-CNN's second stage: rotated RoI align, two shared FCs, and
the class and box FCs.

Port of `jdet_tpu/models/heads/oriented_head.py::OrientedHead` (:49):

- `_sample_rois`: each image's gts are prepended to its proposals, with
  their own masks; the rotated max-IoU assignment (0.5 / 0.5 / 0.5,
  no low-quality match) runs on the per-image proposals with per-image
  masks, one launch of the fused assigner for the batch on the card; a
  random sampler keeps `num` RoIs (at most a quarter positive), moved to
  the front with the positives first (a stable sort).
- `_forward_rois`: (B, S, 7, 7, C) features flattened in (y, x, c) order
  -> 1024 -> 1024 (ReLU) -> `fc_cls` (classes + background, last) and
  `fc_reg` (5 deltas, class-agnostic), cast to float32.
- `loss`: softmax cross entropy over the sampled RoIs and smooth-L1
  (beta 1) on the positives' `rbox2delta` targets (stds 0.1, 0.1, 0.2,
  0.2, 0.1), both averaged over the sampled count of the batch.
- `predict`: softmax scores of the foreground classes, `delta2rbox` from
  the proposals, and `multiclass_nms_rotated` (its per-class IoU on K1's
  matrix on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_convert import delta2rbox, rbox2delta, rbox_to_poly
from ...ops.nms_rotated import multiclass_nms_rotated
from ...utils.registry import HEADS
from ..boxes.assigner import max_iou_assign_rotated
from ..boxes.sampler import random_sample
from ..layers import Linear, normal_init, xavier_uniform_init
from ..losses import cross_entropy_loss, smooth_l1_loss
from ..roi_extractors import OrientedSingleRoIExtractor

DEFAULT_TRAIN_CFG = dict(
    assigner=dict(
        pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
        match_low_quality=False,
    ),
    sampler=dict(num=512, pos_fraction=0.25, neg_pos_ub=-1,
                 add_gt_as_proposals=True),
    pos_weight=-1,
)

DEFAULT_TEST_CFG = dict(score_thr=0.05, nms_iou_thr=0.1, max_per_img=2000)


@HEADS.register_module()
class OrientedHead(nn.Module):
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
        self.num_classes = num_classes
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.train_cfg = {**DEFAULT_TRAIN_CFG, **(train_cfg or {})}
        self.test_cfg = {**DEFAULT_TEST_CFG, **(test_cfg or {})}
        self.roi_extractor = OrientedSingleRoIExtractor(
            out_size=roi_size, featmap_strides=featmap_strides, extend_factor=extend_factor)
        in_dim = in_channels * roi_size * roi_size
        self.shared_fcs = nn.ModuleList([
            Linear(in_dim if i == 0 else fc_out_channels, fc_out_channels,
                   kernel_init=xavier_uniform_init, generator=generator)
            for i in range(num_shared_fcs)
        ])
        self.fc_cls = Linear(fc_out_channels, num_classes + 1, kernel_init=normal_init(0.01),
                             generator=generator)
        self.fc_reg = Linear(fc_out_channels, 5, kernel_init=normal_init(0.001),
                             generator=generator)

    def _forward_rois(self, feats, rois, valid):
        x = self.roi_extractor(feats, rois, valid)  # (B, S, P, P, C)
        x = x.reshape(*x.shape[:2], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()

    @torch.no_grad()
    def _sample_rois(self, proposals, p_valid, gt_bboxes, gt_mask, gt_labels, rand=None,
                     generator=None):
        """Assign and sample each image's proposals (B, P, 5). Returns rois
        (B, S, 5), their validity, labels (0-based classes, background =
        num_classes), label weights, box targets and box weights."""
        cfg = self.train_cfg
        scfg = cfg["sampler"]
        if scfg.get("add_gt_as_proposals", True):
            proposals = torch.cat([gt_bboxes, proposals], 1)
            p_valid = torch.cat([gt_mask, p_valid], 1)
        assign = max_iou_assign_rotated(proposals.contiguous(), gt_bboxes, gt_mask, gt_labels,
                                        anchor_mask=p_valid, **cfg["assigner"])
        sample = random_sample(assign, scfg["num"], scfg["pos_fraction"],
                               scfg.get("neg_pos_ub", -1), rand=rand, generator=generator)
        pos, neg = sample["pos_mask"], sample["neg_mask"]
        S = scfg["num"]
        # the sampled RoIs to the front, positives first
        priority = torch.where(pos, 2, torch.where(neg, 1, 0))
        order = torch.sort(priority, dim=-1, descending=True, stable=True).indices[:, :S]
        sel_valid = torch.gather(pos | neg, 1, order)
        rois = torch.gather(proposals, 1, order[..., None].expand(-1, -1, 5))
        rois = torch.where(sel_valid[..., None], rois, 0.0)
        is_pos = torch.gather(pos, 1, order)
        k = gt_bboxes.shape[1]
        safe_gt = (torch.gather(assign["gt_inds"], 1, order) - 1).clamp(0, k - 1)
        matched = torch.gather(gt_bboxes, 1, safe_gt[..., None].expand(-1, -1, 5))
        enc = rbox2delta(rois, matched, self.target_means, self.target_stds)
        bbox_targets = torch.where(is_pos[..., None], enc, 0.0)
        bbox_weights = is_pos[..., None].to(enc.dtype)
        labels = torch.where(is_pos, (torch.gather(assign["labels"], 1, order) - 1).clamp(min=0),
                             self.num_classes)
        label_weights = sel_valid.to(enc.dtype)
        return rois, sel_valid, labels, label_weights, bbox_targets, bbox_weights

    def loss(self, feats, proposals, targets, rand=None, generator=None):
        """The RoI losses on the RPN's (detached) proposals. The sampler
        draws from `rand` or `generator`."""
        rois, valid, labels, lw, bt, bw = self._sample_rois(
            proposals["boxes"], proposals["valid"], targets["gt_bboxes"].float(),
            targets["gt_mask"].bool(), targets["gt_labels"], rand=rand, generator=generator)
        cls_score, bbox_pred = self._forward_rois(feats, rois, valid)
        avg = (lw > 0).sum().clamp(min=1).to(cls_score.dtype)
        loss_cls = cross_entropy_loss(cls_score, labels, weight=lw, avg_factor=avg)
        loss_bbox = smooth_l1_loss(bbox_pred, bt, weight=bw, beta=1.0, avg_factor=avg)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}

    @torch.no_grad()
    def predict(self, feats, proposals, targets=None):
        """Detections in the fixed-size dict of
        `RotatedRetinaHead.predict`, at `self.test_cfg`."""
        rois, valid = proposals["boxes"], proposals["valid"]
        cls_score, bbox_pred = self._forward_rois(feats, rois, valid)
        scores = torch.softmax(cls_score, -1)[..., :self.num_classes] * valid[..., None]
        boxes = delta2rbox(rois, bbox_pred, self.target_means, self.target_stds)
        if targets is not None and "scale_factor" in targets:
            sf = targets["scale_factor"].reshape(-1, 1, 1).to(boxes)
            boxes = torch.cat([boxes[..., :4] / sf, boxes[..., 4:]], -1)
        cfg = self.test_cfg
        det = multiclass_nms_rotated(boxes, scores, score_thr=cfg["score_thr"],
                                     nms_iou_thr=cfg["nms_iou_thr"],
                                     max_per_img=cfg["max_per_img"])
        det["polys"] = rbox_to_poly(det["boxes"])
        return det
