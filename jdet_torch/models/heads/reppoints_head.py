"""Rotated RepPoints head: 9-point sets, convex GIoU, min-area rects.

Port of `jdet_tpu/models/heads/reppoints_head.py::RotatedRepPointsHead`
(`forward_single` :122, `_points` :150, `_decode_points` :159, `loss`
:170, `predict` :278): a class tower and a point tower of GroupNorm
convs; the point tower predicts 9 (dy, dx) offsets per location in
strides, an init set and a refine set, the refine one added to the init
one with only `gradient_mul` of its gradient.

`loss`:
  - init: `convex_assign_init` (per gt, the `init_pos_num` nearest
    centres of its scale's level), the GIoU loss of each gt's winning
    candidates' init point sets;
  - refine: `max_convex_iou_assign` on the detached init sets' hulls
    against every gt quad, then the GIoU loss of the positives' refine
    sets, read through a budget of M = min(A, 8K) per image (the
    positives of largest IoU, ties to the lower index);
  - the focal loss on the refine assignment's labels, the ignore band
    zero-weighted, over the refine positives.

`predict` cuts each level to its `nms_pre` best max score (ties to the
lower index), decodes the refine points, takes each set's least-area
rectangle (`ops/convex.py::min_area_rect`) and runs
`multiclass_nms_rotated`. Outputs are NCHW; `loss` and `predict` take
them in float32, as the reference does (:172, :280).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_convert import rbox_to_poly
from ...ops.convex import convex_giou, min_area_rect
from ...ops.nms_rotated import multiclass_nms_rotated
from ...ops.topk import stable_topk
from ...utils.registry import HEADS
from ..boxes.assigner import convex_assign_init, max_convex_iou_assign
from ..layers import Conv2d, ConvModule, bias_init_with_prob, normal_init
from ..losses import sigmoid_focal_loss


@HEADS.register_module()
class RotatedRepPointsHead(nn.Module):
    def __init__(
        self,
        num_classes=15,  # foreground
        in_channels=256,
        feat_channels=256,
        point_feat_channels=256,
        stacked_convs=3,
        num_points=9,
        gradient_mul=0.1,
        strides=(8, 16, 32, 64, 128),
        scale_ranges=((-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8)),
        loss_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
        loss_bbox_init=dict(loss_weight=0.375),
        loss_bbox_refine=dict(loss_weight=1.0),
        point_base_scale=4,
        init_pos_num=1,
        refine_assign=dict(pos_iou_thr=0.4, neg_iou_thr=0.3, min_pos_iou=0.0),
        refine_pos_budget=None,
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.num_points = num_points
        self.gradient_mul = gradient_mul
        self.strides = tuple(strides)
        self.scale_ranges = tuple(scale_ranges)
        self.loss_cls_cfg = dict(loss_cls)
        self.loss_init_cfg = dict(loss_bbox_init)
        self.loss_refine_cfg = dict(loss_bbox_refine)
        self.point_base_scale = point_base_scale
        self.init_pos_num = init_pos_num
        self.refine_assign_cfg = dict(refine_assign)
        self.refine_pos_budget = refine_pos_budget
        self.test_cfg = {**dict(nms_pre=2000, score_thr=0.05, nms_iou_thr=0.1,
                                max_per_img=2000), **(test_cfg or {})}

        def tower():
            return nn.ModuleList([
                ConvModule(in_channels if i == 0 else feat_channels, feat_channels, 3,
                           norm="gn", kernel_init=normal_init(0.01), generator=generator)
                for i in range(stacked_convs)])

        def conv(cin, cout, k, bias=0.0):
            return Conv2d(cin, cout, k, kernel_init=normal_init(0.01), bias_value=bias,
                          generator=generator)

        self.cls_convs = tower()
        self.reg_convs = tower()
        self.reppoints_cls = conv(feat_channels, num_classes, 3, bias_init_with_prob(0.01))
        self.pts_init_conv = conv(feat_channels, point_feat_channels, 3)
        self.pts_init_out = conv(point_feat_channels, 2 * num_points, 1)
        self.pts_refine_conv = conv(feat_channels, point_feat_channels, 3)
        self.pts_refine_out = conv(point_feat_channels, 2 * num_points, 1)

    # ------------------------------------------------------------------
    def forward_single(self, x):
        cls_feat, reg_feat = x, x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        off_init = self.pts_init_out(F.relu(self.pts_init_conv(reg_feat)))
        # the refine offsets are relative to the init ones, which pass on
        # only `gradient_mul` of the gradient
        gm = self.gradient_mul
        off_detach = off_init.detach() * (1 - gm) + off_init * gm
        off_refine = self.pts_refine_out(F.relu(self.pts_refine_conv(reg_feat))) + off_detach
        return self.reppoints_cls(cls_feat), off_init, off_refine

    def forward(self, feats):
        """[(cls (B, C, H, W), init offsets (B, 2P, H, W), refine offsets
        (B, 2P, H, W))] per level."""
        return [self.forward_single(f) for f in feats]

    # ------------------------------------------------------------------
    def _points(self, featmap_sizes, device):
        """Per level, the (H * W, 2) point centres, row-major, and their
        strides."""
        pts, strides = [], []
        for (h, w), s in zip(featmap_sizes, self.strides):
            ys, xs = np.mgrid[:int(h), :int(w)].astype(np.float32)
            pts.append(torch.from_numpy(
                np.stack([xs.ravel() * s + s / 2, ys.ravel() * s + s / 2], -1)).to(device))
            strides.append(torch.full((h * w,), float(s), device=device))
        return pts, strides

    def _decode_points(self, offsets, centers, strides_pts):
        """(B, A, 2P) offsets in strides -> (B, A, P, 2) image points; the
        channel pairs are (dy, dx)."""
        B, A, _ = offsets.shape
        off = offsets.reshape(B, A, self.num_points, 2)
        x = centers[..., None, 0] + off[..., 1] * strides_pts[..., None]
        y = centers[..., None, 1] + off[..., 0] * strides_pts[..., None]
        return torch.stack([x, y], -1)

    def _flatten(self, outs, i, c):
        B = outs[0][0].shape[0]
        return torch.cat([o[i].float().permute(0, 2, 3, 1).reshape(B, -1, c) for o in outs], 1)

    def loss(self, outs, targets):
        """targets: gt_bboxes (B, K, 5), gt_labels (B, K) 1-based, gt_mask
        (B, K) bool."""
        featmap_sizes = [tuple(o[0].shape[-2:]) for o in outs]
        cls = self._flatten(outs, 0, self.num_classes)
        pts_list, strides_list = self._points(featmap_sizes, cls.device)
        centers, strides_pts = torch.cat(pts_list), torch.cat(strides_list)
        P2 = 2 * self.num_points
        pts_i = self._decode_points(self._flatten(outs, 1, P2), centers, strides_pts)
        pts_r = self._decode_points(self._flatten(outs, 2, P2), centers, strides_pts)
        B, A = cls.shape[:2]
        gt_mask = targets["gt_mask"].bool()
        gt_labels = targets["gt_labels"]
        gt_polys = rbox_to_poly(targets["gt_bboxes"].float())
        K = gt_polys.shape[1]
        pts_i_flat = pts_i.reshape(B, A, P2)
        pts_r_flat = pts_r.reshape(B, A, P2)

        # init: the reference's ConvexAssigner, then each gt's winners
        assign_i = convex_assign_init(centers, torch.log2(strides_pts), gt_polys, gt_mask,
                                      pos_num=self.init_pos_num, scale=self.point_base_scale)
        cand_idx, cand_win = assign_i["cand_idx"], assign_i["cand_win"]
        P = cand_idx.shape[-1]
        pos_i = torch.gather(pts_i_flat, 1, cand_idx.reshape(B, K * P, 1).expand(-1, -1, P2))
        poly_i = gt_polys[:, :, None, :].expand(B, K, P, 8).reshape(B * K * P, 8)
        w_init = cand_win.reshape(-1).to(cls.dtype)
        gl_i = (1 - convex_giou(pos_i.reshape(B * K * P, P2), poly_i)) * w_init
        loss_init = gl_i.sum() / w_init.sum().clamp(min=1.0) * self.loss_init_cfg.get(
            "loss_weight", 0.375)

        # refine: MaxConvexIoU on the detached init hulls, the positives
        # read through a budget of the M of largest IoU
        assign_r = max_convex_iou_assign(pts_i_flat, gt_polys, gt_mask, gt_labels,
                                         **self.refine_assign_cfg)
        gt_inds_r = assign_r["gt_inds"]  # (B, A): -1 ignore, 0 negative, 1-based
        M = self.refine_pos_budget or min(A, 8 * K)
        pos_r_mask = gt_inds_r > 0
        top_s, top_idx = stable_topk(
            torch.where(pos_r_mask, assign_r["max_overlaps"], float("-inf")), M)
        w_ref = torch.isfinite(top_s).to(cls.dtype).reshape(-1)
        pos_r = torch.gather(pts_r_flat, 1, top_idx[..., None].expand(-1, -1, P2))
        sel_gt = (torch.gather(gt_inds_r, 1, top_idx) - 1).clamp(0, K - 1)
        poly_r = torch.gather(gt_polys, 1, sel_gt[..., None].expand(-1, -1, 8))
        gl_r = (1 - convex_giou(pos_r.reshape(B * M, P2), poly_r.reshape(B * M, 8))) * w_ref
        loss_refine = gl_r.sum() / w_ref.sum().clamp(min=1.0) * self.loss_refine_cfg.get(
            "loss_weight", 1.0)

        # classification from the refine assignment
        cfg = self.loss_cls_cfg
        num_pos = pos_r_mask.sum().clamp(min=1).to(cls.dtype)
        loss_cls = sigmoid_focal_loss(
            cls, assign_r["labels"], weight=(gt_inds_r >= 0).to(cls.dtype),
            gamma=cfg.get("gamma", 2.0), alpha=cfg.get("alpha", 0.25),
            avg_factor=num_pos) * cfg.get("loss_weight", 1.0)
        return {"loss_cls": loss_cls, "loss_pts_init": loss_init,
                "loss_pts_refine": loss_refine}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, outs, targets=None):
        """Fixed-size detections at `self.test_cfg`, in the dict of
        `RotatedRetinaHead.predict`."""
        cfg = self.test_cfg
        nms_pre = cfg["nms_pre"]
        device = outs[0][0].device
        pts_list, strides_list = self._points([tuple(o[0].shape[-2:]) for o in outs], device)
        level_scores, level_boxes = [], []
        for lvl, (cls, _, off_r) in enumerate(outs):
            B = cls.shape[0]
            scores = torch.sigmoid(cls.float().permute(0, 2, 3, 1).reshape(B, -1,
                                                                           self.num_classes))
            offsets = off_r.float().permute(0, 2, 3, 1).reshape(B, -1, 2 * self.num_points)
            centers, strides_pts = pts_list[lvl], strides_list[lvl]
            if 0 < nms_pre < centers.shape[0]:
                _, top = stable_topk(scores.amax(-1), nms_pre)
                scores = torch.gather(scores, 1, top[..., None].expand(-1, -1, self.num_classes))
                offsets = torch.gather(offsets, 1, top[..., None].expand(-1, -1,
                                                                         offsets.shape[-1]))
                centers, strides_pts = centers[top], strides_pts[top]
            else:
                centers = centers.expand(B, -1, -1)
                strides_pts = strides_pts.expand(B, -1)
            pts = self._decode_points(offsets, centers, strides_pts)
            level_boxes.append(min_area_rect(pts.reshape(-1, self.num_points, 2)).reshape(
                B, -1, 5))
            level_scores.append(scores)
        all_scores = torch.cat(level_scores, 1)
        all_boxes = torch.cat(level_boxes, 1)
        if targets is not None and "scale_factor" in targets:
            sf = targets["scale_factor"].reshape(-1, 1, 1).to(all_boxes)
            all_boxes = torch.cat([all_boxes[..., :4] / sf, all_boxes[..., 4:]], -1)
        det = multiclass_nms_rotated(all_boxes, all_scores, score_thr=cfg["score_thr"],
                                     nms_iou_thr=cfg["nms_iou_thr"],
                                     max_per_img=cfg["max_per_img"])
        det["polys"] = rbox_to_poly(det["boxes"])
        return det
