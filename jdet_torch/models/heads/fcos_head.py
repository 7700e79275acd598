"""Rotated FCOS head: anchor-free, centerness-weighted.

Port of `jdet_tpu/models/heads/fcos_head.py::FCOSHead`: cls and reg towers
of conv + GroupNorm + ReLU, a learnable `Scale` per level on the 4
distance channels, a theta channel with its own `Scale`, and a centerness
branch. Targets (`_targets`, the reference's `_target_single` :142 over
the batch) rotate each point into the min-theta frame of every gt to
measure (l, t, r, b), keep the gts whose box holds the point and whose
largest distance falls in the level's regress range, and take the gt of
least area (the first on ties). The losses are the focal loss on 1-based
labels, `rotated_iou_loss` on the decoded boxes weighted by the
centerness targets (the exact aligned IoU, plain PyTorch, as in the
reference), and BCE on the centerness.

With `norm_on_bbox` the distances are in strides: the reference
multiplies them by the stride in its eval-mode forward; here `forward`
is one function for training and eval, and `predict` multiplies (the
same float32 product). `predict` cuts each level to its `nms_pre` best
max(score x centerness) in the reference's tie order and passes the
centerness to the NMS as its score factor. Outputs are NCHW.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_convert import distance2obb, mintheta_obb, rbox_to_poly
from ...ops.nms_rotated import multiclass_nms_rotated
from ...ops.topk import stable_topk
from ...utils.registry import HEADS
from ..layers import Conv2d, ConvModule, Scale, bias_init_with_prob, normal_init
from ..losses import binary_cross_entropy_loss, rotated_iou_loss, sigmoid_focal_loss

INF = 1e8


@HEADS.register_module()
class FCOSHead(nn.Module):
    def __init__(
        self,
        num_classes=15,  # foreground classes (the FCOS convention)
        in_channels=256,
        feat_channels=256,
        stacked_convs=4,
        strides=(8, 16, 32, 64, 128),
        regress_ranges=((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF)),
        center_sampling=False,
        center_sample_radius=1.5,
        norm_on_bbox=True,
        scale_theta=True,
        loss_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
        loss_bbox=dict(mode="linear", loss_weight=1.0),
        loss_centerness=dict(loss_weight=1.0),
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.regress_ranges = tuple(regress_ranges)
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.norm_on_bbox = norm_on_bbox
        self.scale_theta = scale_theta
        self.loss_cls_cfg = dict(loss_cls)
        self.loss_bbox_cfg = dict(loss_bbox)
        self.loss_centerness_cfg = dict(loss_centerness)
        self.test_cfg = {**dict(nms_pre=2000, score_thr=0.05, nms_iou_thr=0.1,
                                max_per_img=2000), **(test_cfg or {})}

        def tower():
            return nn.ModuleList([
                ConvModule(in_channels if i == 0 else feat_channels, feat_channels, 3,
                           norm="gn", kernel_init=normal_init(0.01), generator=generator)
                for i in range(stacked_convs)])

        self.cls_convs = tower()
        self.reg_convs = tower()

        def out_conv(c, bias=0.0):
            return Conv2d(feat_channels, c, 3, kernel_init=normal_init(0.01), bias_value=bias,
                          generator=generator)

        self.conv_cls = out_conv(num_classes, bias_init_with_prob(0.01))
        self.conv_reg = out_conv(4)
        self.conv_theta = out_conv(1)
        self.conv_centerness = out_conv(1)
        self.scales = nn.ModuleList([Scale(1.0) for _ in self.strides])
        self.scale_t = Scale(1.0)

    # ------------------------------------------------------------------
    def _reg_branch(self, reg_feat, level):
        """The distances (in strides with `norm_on_bbox`) and theta of the
        reg tower's output; float32 (the `Scale`s promote)."""
        bbox_pred = self.scales[level](self.conv_reg(reg_feat))
        bbox_pred = F.relu(bbox_pred) if self.norm_on_bbox else torch.exp(bbox_pred)
        theta_pred = self.conv_theta(reg_feat)
        if self.scale_theta:
            theta_pred = self.scale_t(theta_pred)
        return bbox_pred, theta_pred

    def forward_single(self, x, level):
        cls_feat, reg_feat = x, x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        bbox_pred, theta_pred = self._reg_branch(reg_feat, level)
        return self.conv_cls(cls_feat), bbox_pred, theta_pred, self.conv_centerness(reg_feat)

    def forward(self, feats):
        """[(cls (B, C, H, W), distances (B, 4, H, W), theta (B, 1, H, W),
        centerness (B, 1, H, W))] per level."""
        return [self.forward_single(f, lvl) for lvl, f in enumerate(feats)]

    # ------------------------------------------------------------------
    def _points(self, featmap_sizes, device):
        """Per level, the (H * W, 2) point centres, row-major."""
        pts = []
        for (h, w), s in zip(featmap_sizes, self.strides):
            ys, xs = np.mgrid[:h, :w].astype(np.float32)
            pts.append(torch.from_numpy(
                np.stack([xs.ravel() * s + s / 2, ys.ravel() * s + s / 2], -1)).to(device))
        return pts

    def _point_table(self, featmap_sizes, device):
        """All levels' points (N, 2), their regress ranges (N, 2) and
        strides (N,)."""
        pts = self._points(featmap_sizes, device)
        rr = torch.cat([torch.tensor(r, dtype=torch.float32, device=device).expand(len(p), 2)
                        for r, p in zip(self.regress_ranges, pts)])
        strides = torch.cat([torch.full((len(p),), float(s), device=device)
                             for s, p in zip(self.strides, pts)])
        return torch.cat(pts), rr, strides

    def _targets(self, points, regress_ranges, strides_pts, gt_bboxes, gt_mask, gt_labels):
        """The reference's `_target_single` over the batch. points (N, 2);
        gt_bboxes (B, K, 5). Returns labels (B, N) (0-based, background
        = num_classes), bbox_targets (B, N, 5) (l, t, r, b, theta) and pos
        (B, N)."""
        gts = mintheta_obb(gt_bboxes)
        cx, cy, gw, gh, theta = gts.unbind(-1)  # (B, K)
        cos, sin = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
        ox = points[:, 0] - cx[..., None]  # (B, K, N)
        oy = points[:, 1] - cy[..., None]
        off_x = cos * ox + sin * oy
        off_y = -sin * ox + cos * oy
        hw, hh = gw[..., None] / 2, gh[..., None] / 2
        ltrb = torch.stack([hw + off_x, hh + off_y, hw - off_x, hh - off_y], -1)
        inside = ltrb.amin(-1) > 0
        if self.center_sampling:
            r = self.center_sample_radius * strides_pts
            inside = inside & (off_x.abs() < r) & (off_y.abs() < r)
        max_dist = ltrb.amax(-1)
        in_range = (max_dist >= regress_ranges[:, 0]) & (max_dist <= regress_ranges[:, 1])
        areas = torch.where(gt_mask, gw * gh, INF)[..., None].expand_as(max_dist)
        areas = torch.where(inside & in_range & gt_mask[..., None], areas, INF)
        min_area, idx = areas.min(1)  # (B, N); torch.min takes the first on ties
        pos = min_area < INF
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, idx) - 1, self.num_classes)
        bt = torch.gather(ltrb, 1, idx[:, None, :, None].expand(-1, 1, -1, 4))[:, 0]
        th = torch.gather(theta, 1, idx)
        return labels, torch.cat([bt, th[..., None]], -1), pos

    def _flatten(self, outs):
        """cls (B, N, C), distances (B, N, 4), theta (B, N, 1),
        centerness (B, N), all float32."""
        B = outs[0][0].shape[0]

        def cat(i, c):
            return torch.cat([o[i].float().permute(0, 2, 3, 1).reshape(B, -1, c)
                              for o in outs], 1)

        return cat(0, self.num_classes), cat(1, 4), cat(2, 1), cat(3, 1)[..., 0]

    @staticmethod
    def _centerness_targets(bbox_targets, pos):
        lr, tb = bbox_targets[..., [0, 2]], bbox_targets[..., [1, 3]]
        ctr = torch.sqrt(((lr.amin(-1) / lr.amax(-1).clamp(min=1e-6))
                          * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6))).clamp(min=0.0))
        return torch.where(pos, ctr, 0.0)

    def _common_losses(self, outs, targets, cls_avg_extra=0):
        """The targets and what `loss` and H2RBox's `loss_with_aug`
        share: the focal loss (averaged over the positives plus
        `cls_avg_extra`), the centerness targets and BCE."""
        featmap_sizes = [o[0].shape[-2:] for o in outs]
        cls, reg, th, ctr = self._flatten(outs)
        points, rr, strides_pts = self._point_table(featmap_sizes, cls.device)
        labels, bbox_targets, pos = self._targets(
            points, rr, strides_pts, targets["gt_bboxes"].float(), targets["gt_mask"].bool(),
            targets["gt_labels"])
        num_pos = pos.sum().clamp(min=1).float()
        lbl1 = torch.where(labels == self.num_classes, 0, labels + 1)
        cfg = self.loss_cls_cfg
        loss_cls = sigmoid_focal_loss(
            cls, lbl1, gamma=cfg.get("gamma", 2.0), alpha=cfg.get("alpha", 0.25),
            avg_factor=num_pos + cls_avg_extra) * cfg.get("loss_weight", 1.0)
        ctr_tgt = self._centerness_targets(bbox_targets, pos)
        loss_centerness = binary_cross_entropy_loss(
            ctr, ctr_tgt, weight=pos.float(), avg_factor=num_pos,
        ) * self.loss_centerness_cfg.get("loss_weight", 1.0)
        reg_dec = reg * strides_pts[:, None] if self.norm_on_bbox else reg
        pred_obb = distance2obb(points, torch.cat([reg_dec, th], -1))
        tgt_obb = distance2obb(points, bbox_targets)
        return dict(loss_cls=loss_cls, loss_centerness=loss_centerness, labels=labels,
                    pos=pos, ctr_tgt=ctr_tgt, pred_obb=pred_obb, tgt_obb=tgt_obb,
                    points=points, strides_pts=strides_pts, featmap_sizes=featmap_sizes)

    def loss(self, outs, targets):
        """targets: gt_bboxes (B, K, 5), gt_labels (B, K) 1-based, gt_mask
        (B, K) bool."""
        c = self._common_losses(outs, targets)
        w = c["ctr_tgt"]
        cfg = self.loss_bbox_cfg
        loss_bbox = rotated_iou_loss(
            c["pred_obb"].reshape(-1, 5), c["tgt_obb"].reshape(-1, 5), weight=w.reshape(-1),
            mode=cfg.get("mode", "linear"), avg_factor=w.sum().clamp(min=1e-6),
        ) * cfg.get("loss_weight", 1.0)
        return {"loss_cls": c["loss_cls"], "loss_bbox": loss_bbox,
                "loss_centerness": c["loss_centerness"]}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, outs, targets=None):
        """Fixed-size detections at `self.test_cfg`, in the dict of
        `RotatedRetinaHead.predict`."""
        cfg = self.test_cfg
        nms_pre = cfg["nms_pre"]
        pts_list = self._points([o[0].shape[-2:] for o in outs], outs[0][0].device)
        level_scores, level_boxes, level_ctr = [], [], []
        for lvl, (cls, reg, th, ctr) in enumerate(outs):
            B = cls.shape[0]
            scores = torch.sigmoid(cls.float().permute(0, 2, 3, 1).reshape(B, -1, self.num_classes))
            centerness = torch.sigmoid(ctr.float().reshape(B, -1))
            dist = reg.float().permute(0, 2, 3, 1).reshape(B, -1, 4)
            if self.norm_on_bbox:
                dist = dist * self.strides[lvl]
            theta = th.float().reshape(B, -1, 1)
            pts = pts_list[lvl]
            if 0 < nms_pre < pts.shape[0]:
                _, top = stable_topk((scores * centerness[..., None]).amax(-1), nms_pre)
                scores = torch.gather(scores, 1, top[..., None].expand(-1, -1, self.num_classes))
                centerness = torch.gather(centerness, 1, top)
                dist = torch.gather(dist, 1, top[..., None].expand(-1, -1, 4))
                theta = torch.gather(theta, 1, top[..., None])
                pts = pts[top]
            level_scores.append(scores)
            level_boxes.append(distance2obb(pts, torch.cat([dist, theta], -1)))
            level_ctr.append(centerness)
        all_scores = torch.cat(level_scores, 1)
        all_boxes = torch.cat(level_boxes, 1)
        if targets is not None and "scale_factor" in targets:
            sf = targets["scale_factor"].reshape(-1, 1, 1).to(all_boxes)
            all_boxes = torch.cat([all_boxes[..., :4] / sf, all_boxes[..., 4:]], -1)
        det = multiclass_nms_rotated(all_boxes, all_scores, score_thr=cfg["score_thr"],
                                     nms_iou_thr=cfg["nms_iou_thr"],
                                     max_per_img=cfg["max_per_img"],
                                     score_factors=torch.cat(level_ctr, 1))
        det["polys"] = rbox_to_poly(det["boxes"])
        return det
