"""R3Det head: RetinaNet plus a refine stage on refined boxes.

Port of `jdet_tpu/models/heads/r3det_head.py::R3DetHead`, the reference's
completion of JDet's unfinished R3Det (its network file is broken; see
that module's docstring):

  stage 1: the `RotatedRetinaHead` towers, anchors, targets and losses;
  refine: at each location the anchor of highest class confidence (the
  first on ties) decodes its stage-1 deltas, without gradient and with
  `wh_ratio_clip=1e-6`, into one refined box per location; the
  `FeatureRefineModule` re-samples each level at those boxes' centres
  and adds the result to its features;
  stage 2: two 3x3 conv layers per branch and 1x1 output convs regress
  against the refined boxes (one per location) with their own max-IoU
  targets (IoU 0.6 / 0.5), per image (K1's per-image fused assigner on
  the card).

`predict` decodes stage 2's deltas on the refined boxes, after the
per-level `nms_pre` cut in the reference's tie order.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.box_convert import delta2rbox, rbox_to_poly
from ...ops.nms_rotated import multiclass_nms_rotated
from ...ops.roi_ops_extra import FeatureRefineModule
from ...ops.topk import stable_topk
from ...utils.registry import HEADS
from ..boxes.anchor_target import anchor_target_batch
from ..layers import Conv2d, ConvModule, bias_init_with_prob, normal_init
from ..losses import sigmoid_focal_loss, smooth_l1_loss
from .rotated_retina_head import RotatedRetinaHead


@HEADS.register_module()
class R3DetHead(RotatedRetinaHead):
    def __init__(self, *a, refine_train_cfg=None, generator=None, **kw):
        super().__init__(*a, generator=generator, **kw)
        self.frm = FeatureRefineModule(self.feat_channels, self.anchor_strides, points=1,
                                       generator=generator)
        self.refine_train_cfg = {
            "assigner": dict(pos_iou_thr=0.6, neg_iou_thr=0.5, min_pos_iou=0.0),
            "allowed_border": -1,
            "pos_weight": -1,
            **(refine_train_cfg or {}),
        }
        c = self.feat_channels

        def tower():
            return nn.ModuleList([ConvModule(c, c, 3, kernel_init=normal_init(0.01),
                                             generator=generator) for _ in range(2)])

        self.refine_reg_convs = tower()
        self.refine_cls_convs = tower()
        self.refine_reg = Conv2d(c, 5, 1, kernel_init=normal_init(0.01), generator=generator)
        self.refine_cls = Conv2d(c, self.cls_out_channels, 1, kernel_init=normal_init(0.01),
                                 bias_value=bias_init_with_prob(0.01), generator=generator)

    # ------------------------------------------------------------------
    def _refined_boxes(self, feat, cls, reg, level):
        """(B, H, W, 5): each location's most confident anchor, decoded."""
        B, _, H, W = feat.shape
        A, C = self.num_anchors, self.cls_out_channels
        anchors = self.anchor_generators[level].grid_anchors(
            (H, W), self.anchor_strides[level], device=feat.device).reshape(H * W, A, 5)
        # the decode in float32 on the deltas' values, as XLA decodes the
        # reference's bf16 deltas in a fused chain (as S2ANet's FAM)
        deltas = reg.detach().float().permute(0, 2, 3, 1).reshape(B, H * W, A, 5)
        conf = cls.detach().float().permute(0, 2, 3, 1).reshape(B, H * W, A, C).amax(-1)
        best = conf.argmax(-1)  # (B, HW): the first of tied maxima
        idx = best[..., None, None].expand(B, H * W, 1, 5)
        d = torch.gather(deltas, 2, idx)[:, :, 0]
        a = torch.gather(anchors.expand(B, -1, -1, -1), 2, idx)[:, :, 0]
        boxes = delta2rbox(a, d, self.target_means, self.target_stds, wh_ratio_clip=1e-6)
        return boxes.reshape(B, H, W, 5)

    def forward(self, feats):
        """[((cls, reg) of stage 1, (cls, reg) of stage 2, refined boxes
        (B, H, W, 5))] per level; the outputs NCHW."""
        stage1 = [self.forward_single(f) for f in feats]
        refined = [self._refined_boxes(f, cls, reg, lvl)
                   for lvl, (f, (cls, reg)) in enumerate(zip(feats, stage1))]
        stage2 = []
        for f in self.frm(list(feats), refined):
            reg_feat, cls_feat = f, f
            for conv in self.refine_reg_convs:
                reg_feat = conv(reg_feat)
            for conv in self.refine_cls_convs:
                cls_feat = conv(cls_feat)
            stage2.append((self.refine_cls(cls_feat), self.refine_reg(reg_feat)))
        return list(zip(stage1, stage2, refined))

    # ------------------------------------------------------------------
    def loss(self, outs, targets):
        """Stage 1's losses as `loss_init_cls` / `loss_init_bbox` and the
        refine stage's as `loss_refine_cls` / `loss_refine_bbox`."""
        base = super().loss([o[0] for o in outs], targets)
        losses = {"loss_init_cls": base["loss_cls"], "loss_init_bbox": base["loss_bbox"]}
        B = outs[0][1][0].shape[0]
        C = self.cls_out_channels
        cls = torch.cat([self._nhwc(o[1][0].float(), B, C) for o in outs], 1)
        reg = torch.cat([self._nhwc(o[1][1].float(), B, 5) for o in outs], 1)
        anchors = torch.cat([o[2].reshape(B, -1, 5) for o in outs], 1)
        cfg = self.refine_train_cfg
        tgt, num_pos, _ = anchor_target_batch(
            anchors,
            torch.ones(anchors.shape[1], dtype=torch.bool, device=anchors.device),
            targets["gt_bboxes"].float(),
            targets["gt_mask"].bool(),
            targets["gt_labels"],
            target_means=self.target_means,
            target_stds=self.target_stds,
            assigner_cfg=dict(cfg["assigner"]),
            pos_weight=cfg.get("pos_weight", -1),
        )
        num_total = num_pos.clamp(min=1).float()
        losses["loss_refine_cls"] = sigmoid_focal_loss(
            cls, tgt["labels"], weight=tgt["label_weights"], avg_factor=num_total)
        losses["loss_refine_bbox"] = smooth_l1_loss(
            reg, tgt["bbox_targets"], weight=tgt["bbox_weights"], beta=1.0 / 9.0,
            avg_factor=num_total)
        return losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, outs, targets=None):
        """Stage 2's detections on the refined boxes, in the fixed-size
        dict of `RotatedRetinaHead.predict`."""
        cfg = self.test_cfg
        nms_pre = cfg["nms_pre"]
        C = self.cls_out_channels
        level_scores, level_boxes = [], []
        for _, (cls, reg), refined in outs:
            B = cls.shape[0]
            scores = torch.sigmoid(self._nhwc(cls.float(), B, C))
            deltas = self._nhwc(reg.float(), B, 5)
            anchors = refined.float().reshape(B, -1, 5)
            if 0 < nms_pre < anchors.shape[1]:
                _, top = stable_topk(scores.amax(-1), nms_pre)
                scores = torch.gather(scores, 1, top[..., None].expand(-1, -1, C))
                deltas = torch.gather(deltas, 1, top[..., None].expand(-1, -1, 5))
                anchors = torch.gather(anchors, 1, top[..., None].expand(-1, -1, 5))
            level_scores.append(scores)
            level_boxes.append(delta2rbox(anchors, deltas, self.target_means,
                                          self.target_stds))
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
