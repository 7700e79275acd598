"""The SSD multibox head with hard-negative mining.

Port of `jdet_tpu/models/heads/ssd_head.py` (`ssd_anchors` :28, `SSDHead`
:51, its loss :112 and `predict` :164): per level a 3x3 conv to
A x (C + 1) class logits (background last) and one to A x 4 deltas, over
SSD's anchors (a min-size and a sqrt(min x max) square and two boxes per
aspect ratio at each cell, (y, x, anchor) order: 8,732 at 300²).

The loss assigns each image's horizontal gts to the anchors by max IoU
(0.5 / 0.5, `min_pos_iou` 0: `anchor_target_batch(rotated=False)`, the
hbb IoU on either device, no IoU kernel), takes the (C + 1)-way
log-softmax cross entropy, and keeps the positives and, per image, the
`neg_pos_ratio` x max(positives, 1) negatives of largest loss: the
reference ranks them by `argsort(argsort(-loss))` with JAX's stable
sort, here a stable sort and its inverse permutation, so equal losses
rank by anchor index on both devices. `predict` keeps the `nms_pre`
anchors of highest best class score (`stable_topk`, ties to the lower
index), decodes them (`delta2hbox`), turns them into zero-angle rboxes,
divides by the scale factor and runs `multiclass_nms_rotated`, whose
per-class IoU is K1's matrix kernel on the card.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.box_convert import delta2hbox, hbox_to_rbox, rbox_to_hbox, rbox_to_poly
from ...ops.nms_rotated import multiclass_nms_rotated
from ...ops.topk import stable_topk
from ...utils.registry import HEADS
from ..boxes.anchor_target import anchor_target_batch
from ..layers import Conv2d, normal_init
from ..losses import smooth_l1_loss


def ssd_anchors(featmap_size, stride, min_size, max_size, ratios):
    """One level's (H * W * A, 4) float32 anchors, (x1, y1, x2, y2), in the
    reference's numpy arithmetic."""
    h, w = featmap_size
    ws = [min_size, float(np.sqrt(min_size * max_size))]
    hs = [min_size, float(np.sqrt(min_size * max_size))]
    for r in ratios:
        sr = float(np.sqrt(r))
        ws += [min_size * sr, min_size / sr]
        hs += [min_size / sr, min_size * sr]
    ws = np.asarray(ws, np.float32)
    hs = np.asarray(hs, np.float32)
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    cx = (xs.ravel() + 0.5) * stride
    cy = (ys.ravel() + 0.5) * stride
    x1 = cx[:, None] - ws[None] / 2
    y1 = cy[:, None] - hs[None] / 2
    x2 = cx[:, None] + ws[None] / 2
    y2 = cy[:, None] + hs[None] / 2
    return np.stack([x1, y1, x2, y2], -1).reshape(-1, 4)


@HEADS.register_module()
class SSDHead(nn.Module):
    def __init__(
        self,
        num_classes=15,
        in_channels=(512, 1024, 512, 256, 256, 256),
        strides=(8, 16, 32, 64, 100, 300),
        min_sizes=(30, 60, 111, 162, 213, 264),
        max_sizes=(60, 111, 162, 213, 264, 315),
        ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
        target_means=(0.0,) * 4,
        target_stds=(0.1, 0.1, 0.2, 0.2),
        neg_pos_ratio=3,
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.min_sizes = tuple(min_sizes)
        self.max_sizes = tuple(max_sizes)
        self.ratios = tuple(tuple(r) for r in ratios)
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.neg_pos_ratio = neg_pos_ratio
        self.test_cfg = {**dict(nms_pre=1000, score_thr=0.02, nms_iou_thr=0.45,
                                max_per_img=200), **(test_cfg or {})}
        self.num_anchors = [2 + 2 * len(r) for r in self.ratios]
        init = normal_init(0.01)
        self.cls_convs = nn.ModuleList(
            Conv2d(ch, na * (num_classes + 1), 3, kernel_init=init, generator=generator)
            for ch, na in zip(in_channels, self.num_anchors))
        self.reg_convs = nn.ModuleList(
            Conv2d(ch, na * 4, 3, kernel_init=init, generator=generator)
            for ch, na in zip(in_channels, self.num_anchors))
        self._anchor_cache = {}

    def forward(self, feats):
        return [(self.cls_convs[i](f), self.reg_convs[i](f)) for i, f in enumerate(feats)]

    def anchors(self, featmap_sizes, device):
        """(N, 4) anchors of all levels for these feature map sizes."""
        key = (tuple(featmap_sizes), str(device))
        if key not in self._anchor_cache:
            flat = np.concatenate([
                ssd_anchors(fs, s, mn, mx, r) for fs, s, mn, mx, r in zip(
                    featmap_sizes, self.strides, self.min_sizes, self.max_sizes, self.ratios)
            ], 0)
            self._anchor_cache[key] = torch.from_numpy(flat).to(device)
        return self._anchor_cache[key]

    def _flatten(self, outs):
        """float32 (B, N, C + 1) logits, (B, N, 4) deltas and the anchors."""
        b = outs[0][0].shape[0]
        c1 = self.num_classes + 1
        cls = torch.cat([o[0].float().permute(0, 2, 3, 1).reshape(b, -1, c1) for o in outs], 1)
        reg = torch.cat([o[1].float().permute(0, 2, 3, 1).reshape(b, -1, 4) for o in outs], 1)
        anchors = self.anchors([tuple(o[0].shape[-2:]) for o in outs], cls.device)
        return cls, reg, anchors

    def loss(self, outs, targets):
        cls, reg, anchors = self._flatten(outs)
        gt_h = targets.get("gt_hboxes")
        if gt_h is None:
            gt_h = rbox_to_hbox(targets["gt_bboxes"])
        tgt, num_pos, _ = anchor_target_batch(
            anchors, torch.ones(anchors.shape[0], dtype=torch.bool, device=anchors.device),
            gt_h, targets["gt_mask"], targets["gt_labels"],
            target_means=self.target_means, target_stds=self.target_stds,
            assigner_cfg=dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0),
            rotated=False,
        )
        num_pos = num_pos.clamp(min=1).to(cls.dtype)
        # 1-based foreground labels -> softmax index, background last
        lbl = torch.where(tgt["labels"] > 0, tgt["labels"] - 1, self.num_classes).long()
        ce = -torch.gather(torch.log_softmax(cls, -1), -1, lbl[..., None])[..., 0]
        pos, neg_cand = tgt["pos_mask"], tgt["neg_mask"]
        # hard-negative mining: each image's candidates ranked by loss
        neg_loss = torch.where(neg_cand, ce.detach(), float("-inf"))
        order = torch.argsort(-neg_loss, dim=-1, stable=True)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order))
        num_neg = self.neg_pos_ratio * pos.sum(-1, keepdim=True).clamp(min=1)
        neg_sel = neg_cand & (rank < num_neg)
        loss_cls = torch.where(pos | neg_sel, ce, 0.0).sum() / num_pos
        loss_bbox = smooth_l1_loss(reg, tgt["bbox_targets"], weight=tgt["bbox_weights"],
                                   beta=1.0, avg_factor=num_pos)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}

    def predict(self, outs, targets=None):
        """Fixed-shape detections at `self.test_cfg`: polys (B, max_per_img,
        8), boxes (B, max_per_img, 5), scores, labels (0-based, -1 where
        invalid) and valid."""
        cfg = self.test_cfg
        cls, reg, anchors = self._flatten(outs)
        scores = torch.softmax(cls, -1)[..., :self.num_classes]
        pre = min(cfg["nms_pre"], anchors.shape[0])
        _, topk = stable_topk(scores.amax(-1), pre)
        scores = torch.gather(scores, 1, topk[..., None].expand(-1, -1, scores.shape[-1]))
        deltas = torch.gather(reg, 1, topk[..., None].expand(-1, -1, 4))
        boxes = hbox_to_rbox(delta2hbox(anchors[topk], deltas, self.target_means,
                                        self.target_stds))
        if targets is not None and "scale_factor" in targets:
            sf = targets["scale_factor"].reshape(-1, 1, 1).to(boxes)
            boxes = torch.cat([boxes[..., :4] / sf, boxes[..., 4:]], -1)
        det = multiclass_nms_rotated(boxes, scores, score_thr=cfg["score_thr"],
                                     nms_iou_thr=cfg["nms_iou_thr"],
                                     max_per_img=cfg["max_per_img"])
        det["polys"] = rbox_to_poly(det["boxes"])
        return det
