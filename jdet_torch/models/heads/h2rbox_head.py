"""H2RBox head: FCOS with weak horizontal supervision and a rotated view.

Port of `jdet_tpu/models/heads/h2rbox_head.py` (`obb2xyxy`,
`hbb_iou_loss`, `H2RBoxHead`):

  - the main view is supervised only through the circumscribed rectangle
    of each decoded box against that of its (horizontal) target, by an
    xyxy IoU loss;
  - a second view, the image rotated by `rot`, runs the regression tower
    alone (`forward_aug`); every location of the main view maps through
    the rotation to a cell of the second view's grid (`_aug_index_map`,
    rounding half to even as `jnp.round` does), and the second view's box
    there is tied to the main view's box rotated by `rot` with a rotated
    IoU loss; the angle target of `rotation_agnostic_classes` is zeroed;
  - `predict` replaces the boxes of `rect_classes` by their
    circumscribed rectangles.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.box_convert import distance2obb, rbox_to_poly
from ...utils.registry import HEADS
from ..losses import rotated_iou_loss
from .fcos_head import FCOSHead


def obb2xyxy(rb):
    """(..., 5) rbox -> (..., 4) its circumscribed axis-aligned rect."""
    w, h, a = rb[..., 2], rb[..., 3], rb[..., 4]
    cosa, sina = torch.cos(a).abs(), torch.sin(a).abs()
    hw = cosa * w + sina * h
    hh = sina * w + cosa * h
    cx, cy = rb[..., 0], rb[..., 1]
    return torch.stack([cx - hw / 2, cy - hh / 2, cx + hw / 2, cy + hh / 2], -1)


def hbb_iou_loss(pred, target, weight=None, avg_factor=None, eps=1e-6):
    """Aligned xyxy IoU loss, linear (1 - IoU), summed over
    max(avg_factor, 1e-6)."""
    x1 = torch.maximum(pred[..., 0], target[..., 0])
    y1 = torch.maximum(pred[..., 1], target[..., 1])
    x2 = torch.minimum(pred[..., 2], target[..., 2])
    y2 = torch.minimum(pred[..., 3], target[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ap = (pred[..., 2] - pred[..., 0]).clamp(min=0) * (pred[..., 3] - pred[..., 1]).clamp(min=0)
    at = ((target[..., 2] - target[..., 0]).clamp(min=0)
          * (target[..., 3] - target[..., 1]).clamp(min=0))
    loss = 1 - inter / (ap + at - inter).clamp(min=eps)
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        avg_factor = max(loss.shape[-1], 1)
    avg = torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device)
    return loss.sum() / avg.clamp(min=1e-6)


@HEADS.register_module()
class H2RBoxHead(FCOSHead):
    def __init__(self, *args, rotation_agnostic_classes=None, rect_classes=None,
                 loss_bbox_aug=dict(mode="linear", loss_weight=1.0), **kw):
        super().__init__(*args, **kw)
        self.rotation_agnostic_classes = tuple(rotation_agnostic_classes or ())
        self.rect_classes = tuple(rect_classes or ())
        self.loss_bbox_aug_cfg = dict(loss_bbox_aug)

    def forward_aug(self, feats):
        """The rotated view: [(distances, theta)] per level, from the
        regression tower alone."""
        outs = []
        for lvl, x in enumerate(feats):
            reg_feat = x
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            outs.append(self._reg_branch(reg_feat, lvl))
        return outs

    def _aug_index_map(self, featmap_sizes, rot, img_center, device):
        """(N,) index into the rotated view's points for every point of
        the main view, and whether that cell lies in the grid."""
        idx_parts, valid_parts = [], []
        offset = 0
        cx, cy = img_center
        cos, sin = torch.cos(rot), torch.sin(rot)
        for (h, w), s in zip(featmap_sizes, self.strides):
            ys, xs = np.mgrid[:h, :w].astype(np.float32)
            px = torch.from_numpy(xs.ravel() * s + s / 2).to(device)
            py = torch.from_numpy(ys.ravel() * s + s / 2).to(device)
            rx = cos * (px - cx) - sin * (py - cy) + cx
            ry = sin * (px - cx) + cos * (py - cy) + cy
            cell_x = torch.round((rx - s / 2) / s).long()
            cell_y = torch.round((ry - s / 2) / s).long()
            ok = (cell_x >= 0) & (cell_x < w) & (cell_y >= 0) & (cell_y < h)
            idx_parts.append(cell_y.clamp(0, h - 1) * w + cell_x.clamp(0, w - 1) + offset)
            valid_parts.append(ok)
            offset += h * w
        return torch.cat(idx_parts), torch.cat(valid_parts)

    def _rotation_agnostic_mask(self, labels):
        m = torch.zeros_like(labels, dtype=torch.bool)
        for c in self.rotation_agnostic_classes:
            m = m | (labels == c)
        return m

    def loss_with_aug(self, outs, outs_aug, rot, targets):
        """The main view's losses (focal averaged over the positives plus
        the batch size, the circumscribed-rect IoU, centerness) and
        `loss_bbox_aug`, the rotated view's consistency. `rot` is the
        rotation (a float32 scalar tensor)."""
        B = outs[0][0].shape[0]
        c = self._common_losses(outs, targets, cls_avg_extra=B)
        ctr_tgt, pos, pred_obb = c["ctr_tgt"], c["pos"], c["pred_obb"]
        loss_bbox = hbb_iou_loss(
            obb2xyxy(pred_obb.reshape(-1, 5)), obb2xyxy(c["tgt_obb"].reshape(-1, 5)),
            weight=ctr_tgt.reshape(-1), avg_factor=ctr_tgt.sum().clamp(min=1e-6),
        ) * self.loss_bbox_cfg.get("loss_weight", 1.0)

        # the consistency of the rotated view
        h0, w0 = c["featmap_sizes"][0]
        cx_img = (w0 * self.strides[0] - 1) / 2.0
        cy_img = (h0 * self.strides[0] - 1) / 2.0
        rot = torch.as_tensor(rot, dtype=torch.float32, device=pred_obb.device)
        aug_idx, aug_ok = self._aug_index_map(c["featmap_sizes"], rot, (cx_img, cy_img),
                                              pred_obb.device)
        reg_aug = torch.cat([o[0].float().permute(0, 2, 3, 1).reshape(B, -1, 4)
                             for o in outs_aug], 1)
        th_aug = torch.cat([o[1].float().permute(0, 2, 3, 1).reshape(B, -1, 1)
                            for o in outs_aug], 1)
        if self.norm_on_bbox:
            reg_aug = reg_aug * c["strides_pts"][:, None]
        aug_all = distance2obb(c["points"], torch.cat([reg_aug, th_aug], -1))
        aug_at = aug_all[:, aug_idx]
        cos, sin = torch.cos(rot), torch.sin(rot)
        x1 = pred_obb[..., 0] - cx_img
        y1 = pred_obb[..., 1] - cy_img
        ta = torch.where(self._rotation_agnostic_mask(c["labels"]), 0.0, pred_obb[..., 4] + rot)
        target_aug = torch.stack([cos * x1 - sin * y1 + cx_img, sin * x1 + cos * y1 + cy_img,
                                  pred_obb[..., 2], pred_obb[..., 3], ta], -1)
        w_aug = ctr_tgt * pos.float() * aug_ok.float()
        cfg = self.loss_bbox_aug_cfg
        loss_bbox_aug = rotated_iou_loss(
            aug_at.reshape(-1, 5), target_aug.reshape(-1, 5), weight=w_aug.reshape(-1),
            mode=cfg.get("mode", "linear"), avg_factor=w_aug.sum().clamp(min=1.0),
        ) * cfg.get("loss_weight", 1.0)
        return {"loss_cls": c["loss_cls"], "loss_bbox": loss_bbox,
                "loss_centerness": c["loss_centerness"], "loss_bbox_aug": loss_bbox_aug}

    @torch.no_grad()
    def predict(self, outs, targets=None):
        det = super().predict(outs, targets)
        if self.rect_classes:
            is_rect = torch.zeros_like(det["labels"], dtype=torch.bool)
            for c in self.rect_classes:
                is_rect = is_rect | (det["labels"] == c)
            boxes = det["boxes"]
            xyxy = obb2xyxy(boxes)
            rect = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2],
                              torch.zeros_like(boxes[..., :1])], -1)
            det["boxes"] = torch.where(is_rect[..., None], rect, boxes)
            det["polys"] = rbox_to_poly(det["boxes"])
        return det
