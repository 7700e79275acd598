"""Rotated RetinaNet head.

Port of `jdet_tpu/models/heads/rotated_retina_head.py::RotatedRetinaHead`
(:59; `forward_single` :149, `_reg_to_deltas` :173, `_flatten_outs` :178,
`loss` :187, `_bbox_loss` :241, `predict` :357) and its loss variants
(`GWDRetinaHead`, `KLDRetinaHead`, `KFIoURRetinaHead`, `RotatedATSSHead`,
`RSDetHead`, :420-477): 4-conv cls and reg towers, A anchors per location
predicting (dx, dy, dw, dh, da) deltas and C = num_classes - 1 sigmoid
class scores; max-IoU (or ATSS) assignment on rotated IoU; focal loss
plus the regression loss of `loss_bbox["type"]` (smooth-L1 on deltas;
GWD / KLD / BCD / IoU / RIDet on decoded boxes against the gts
themselves; KFIoU on both; RSDet's modulated loss), averaged by the total
positives; test-time per-level top-k -> decode -> multiclass rotated
NMS, fixed output size. `poly_iou` and `poly_giou` (with
`ops/convex.py`) are not ported and raise.

Head outputs are NCHW. Anchors run (H, W, A), so `_flatten_outs`
permutes to NHWC before the reshape: channel a*C + c lands at anchor a,
class c. Under a compute dtype (`models/nn.py`) the towers and the output
convs compute in it and `forward` returns it; `loss` and `predict` cast
the outputs to float32 first, where the reference does (:194, :365), so
the anchors, the assigner, the codecs, the losses and the NMS run in
float32.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.box_convert import delta2rbox, rbox_to_poly
from ...ops.nms_rotated import multiclass_nms_rotated
from ...utils.registry import HEADS
from ..boxes.anchor_generator import AnchorGeneratorRotated
from ..boxes.anchor_target import anchor_target_batch
from ..layers import Conv2d, ConvModule, bias_init_with_prob, normal_init
from ..losses import (gaussian_dist_loss, kf_iou_loss, ridet_loss, rotated_iou_loss,
                      rsdet_loss, sigmoid_focal_loss, smooth_l1_loss)

# regression losses on decoded boxes, against the matched gts themselves
# (the reference's reg_decoded_bbox, rotated_retina_head.py:198-201)
REG_DECODED = ("gwd", "kld", "bcd", "iou", "poly_iou", "poly_giou", "ridet")
# the losses of the reference's dispatch that wait for a module of their own
NOT_PORTED = {"poly_iou": "ops/convex.py (ROADMAP queue 1 item 11)",
              "poly_giou": "ops/convex.py (ROADMAP queue 1 item 11)"}

DEFAULT_TRAIN_CFG = dict(
    assigner=dict(
        pos_iou_thr=0.5,
        neg_iou_thr=0.4,
        min_pos_iou=0.0,
    ),
    pos_weight=-1,
)

DEFAULT_TEST_CFG = dict(
    nms_pre=2000,
    score_thr=0.05,
    nms_iou_thr=0.1,
    max_per_img=2000,
)


@HEADS.register_module()
class RotatedRetinaHead(nn.Module):
    def __init__(
        self,
        num_classes,
        in_channels,
        feat_channels=256,
        stacked_convs=4,
        octave_base_scale=4,
        scales_per_octave=3,
        anchor_ratios=(1.0, 0.5, 2.0),
        anchor_strides=(8, 16, 32, 64, 128),
        anchor_base_sizes=None,
        anchor_angles=(0.0,),
        target_means=(0.0,) * 5,
        target_stds=(1.0,) * 5,
        loss_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
        loss_bbox=dict(beta=1.0 / 9.0, loss_weight=1.0),
        train_cfg=None,
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        # num_classes includes background; sigmoid logits have
        # num_classes - 1 channels
        self.num_classes = num_classes
        self.cls_out_channels = num_classes - 1
        self.anchor_strides = tuple(anchor_strides)
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.loss_cls_cfg = dict(loss_cls)
        self.loss_bbox_cfg = dict(loss_bbox)
        kind = self.loss_bbox_cfg.get("type", "smooth_l1")
        if kind in NOT_PORTED:
            raise NotImplementedError(
                f"loss_bbox {kind!r} is not ported: it needs {NOT_PORTED[kind]}")
        if kind not in ("smooth_l1", "gwd", "kld", "bcd", "kfiou", "rsdet", "iou", "ridet"):
            raise ValueError(f"unknown loss_bbox {kind!r}")
        self.train_cfg = {**DEFAULT_TRAIN_CFG, **(train_cfg or {})}
        self.test_cfg = {**DEFAULT_TEST_CFG, **(test_cfg or {})}

        base_sizes = (
            list(anchor_strides) if anchor_base_sizes is None else anchor_base_sizes
        )
        self.anchor_generators = [
            AnchorGeneratorRotated(
                bs,
                octave_base_scale=octave_base_scale,
                scales_per_octave=scales_per_octave,
                ratios=anchor_ratios,
                angles=anchor_angles,
            )
            for bs in base_sizes
        ]
        self.num_anchors = self.anchor_generators[0].num_base_anchors
        self.feat_channels = feat_channels

        def tower():
            return nn.ModuleList(
                [
                    ConvModule(in_channels if i == 0 else feat_channels,
                               feat_channels, 3, kernel_init=normal_init(0.01),
                               generator=generator)
                    for i in range(stacked_convs)
                ]
            )

        self.reg_convs = tower()
        self.cls_convs = tower()
        self.retina_reg = Conv2d(
            feat_channels, self.num_anchors * 5, 1,
            kernel_init=normal_init(0.01), generator=generator,
        )
        self.retina_cls = Conv2d(
            feat_channels, self.num_anchors * self.cls_out_channels, 1,
            kernel_init=normal_init(0.01),
            bias_value=bias_init_with_prob(0.01), generator=generator,
        )

    # ------------------------------------------------------------------
    def forward_single(self, x):
        reg_feat = x
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        cls_feat = x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        return self.retina_cls(cls_feat), self.retina_reg(reg_feat)

    def forward(self, feats):
        """[(cls (B, A*C, H, W), reg (B, A*5, H, W))] per level."""
        return [self.forward_single(f) for f in feats]

    # ------------------------------------------------------------------
    def _flat_anchors(self, featmap_sizes, device):
        return torch.cat(
            [
                gen.grid_anchors(tuple(fs), s, device=device)
                for gen, fs, s in zip(
                    self.anchor_generators, featmap_sizes, self.anchor_strides
                )
            ],
            0,
        )

    @staticmethod
    def _nhwc(x, b, c):
        """NCHW level output -> (b, H * W * A, c)."""
        return x.permute(0, 2, 3, 1).reshape(b, -1, c)

    def _reg_to_deltas(self, reg, b):
        """One level's NCHW regression output -> (b, H * W * A, 5) deltas
        (the hook of the distribution heads)."""
        return self._nhwc(reg, b, 5)

    def _predict_deltas(self, out, b):
        """One level's outputs -> the (b, H * W * A, 5) deltas `predict`
        decodes (the hook of the CSL head)."""
        return self._reg_to_deltas(out[1].float(), b)

    def _flatten_outs(self, outs):
        """[(cls NCHW, reg NCHW)] -> (B, A_total, C), (B, A_total, 5)."""
        b = outs[0][0].shape[0]
        return (torch.cat([self._nhwc(o[0], b, self.cls_out_channels) for o in outs], 1),
                torch.cat([self._reg_to_deltas(o[1], b) for o in outs], 1))

    def loss(self, outs, targets):
        """Losses from head outputs. targets: gt_bboxes (B, K, 5),
        gt_labels (B, K) 1-based, gt_mask (B, K) bool."""
        return self._losses_and_targets(outs, targets)[0]

    def _losses_and_targets(self, outs, targets):
        """`loss`'s dict, with what a head that adds a loss of its own
        needs: the float32 outputs, `anchor_target_batch`'s dict and the
        total positives (at least 1). The ATSS assigner gets the anchors
        per level."""
        outs = [tuple(t.float() for t in o) for o in outs]
        cls_scores, bbox_preds = self._flatten_outs(outs)
        featmap_sizes = [o[0].shape[-2:] for o in outs]
        anchors = self._flat_anchors(featmap_sizes, cls_scores.device)
        tcfg = self.train_cfg
        assigner_cfg = dict(tcfg["assigner"])
        if assigner_cfg.get("type") == "atss":
            assigner_cfg.setdefault("num_level_anchors", [
                int(fs[0]) * int(fs[1]) * self.num_anchors for fs in featmap_sizes])
        tgt, num_pos, _ = anchor_target_batch(
            anchors,
            torch.ones(anchors.shape[0], dtype=torch.bool, device=anchors.device),
            targets["gt_bboxes"].float(),
            targets["gt_mask"].bool(),
            targets["gt_labels"],
            target_means=self.target_means,
            target_stds=self.target_stds,
            assigner_cfg=assigner_cfg,
            pos_weight=tcfg.get("pos_weight", -1),
            reg_decoded_bbox=self.loss_bbox_cfg.get("type", "smooth_l1") in REG_DECODED,
        )
        num_total = num_pos.clamp(min=1).float()
        loss_cls = sigmoid_focal_loss(
            cls_scores,
            tgt["labels"],
            weight=tgt["label_weights"],
            gamma=self.loss_cls_cfg.get("gamma", 2.0),
            alpha=self.loss_cls_cfg.get("alpha", 0.25),
            avg_factor=num_total,
        ) * self.loss_cls_cfg.get("loss_weight", 1.0)
        loss_bbox = self._bbox_loss(anchors, bbox_preds, tgt, num_total)
        losses = {"loss_cls": loss_cls,
                  "loss_bbox": loss_bbox * self.loss_bbox_cfg.get("loss_weight", 1.0)}
        return losses, outs, tgt, num_total

    def _decode(self, anchors, deltas):
        return delta2rbox(anchors, deltas, self.target_means, self.target_stds)

    def _bbox_loss(self, anchors, bbox_preds, tgt, num_total):
        """The regression loss of `loss_bbox["type"]` on (B, N, 5) deltas
        against the targets of every anchor, weighted by the positives."""
        cfg = self.loss_bbox_cfg
        kind = cfg.get("type", "smooth_l1")
        w1 = tgt["bbox_weights"][..., 0].reshape(-1)
        targets = tgt["bbox_targets"]
        if kind == "smooth_l1":
            return smooth_l1_loss(bbox_preds, targets, weight=tgt["bbox_weights"],
                                  beta=cfg.get("beta", 1.0 / 9.0), avg_factor=num_total)
        if kind in ("gwd", "kld", "bcd"):
            extra = {"compat_ref": cfg["compat_ref"]} if kind == "kld" and "compat_ref" in cfg \
                else {}
            return gaussian_dist_loss(
                self._decode(anchors, bbox_preds).reshape(-1, 5), targets.reshape(-1, 5),
                loss_type=kind, weight=w1, fun=cfg.get("fun", "log1p"),
                tau=cfg.get("tau", 1.0), avg_factor=num_total, **extra)
        if kind == "kfiou":
            # the centers on the deltas, the shapes on both sides decoded
            return kf_iou_loss(
                bbox_preds.reshape(-1, 5), targets.reshape(-1, 5),
                pred_decode=self._decode(anchors, bbox_preds).reshape(-1, 5),
                targets_decode=self._decode(anchors, targets).reshape(-1, 5),
                weight=w1, avg_factor=num_total)
        if kind == "rsdet":
            return rsdet_loss(
                bbox_preds.reshape(-1, 5), targets.reshape(-1, 5),
                anchors.expand(bbox_preds.shape[0], -1, -1).reshape(-1, 5),
                weight=w1, sigma=cfg.get("sigma", 3.0), avg_factor=num_total)
        if kind == "ridet":
            return ridet_loss(
                self._decode(anchors, bbox_preds).reshape(-1, 5), targets.reshape(-1, 5),
                weight=w1, beta=cfg.get("beta", 1.0), avg_factor=num_total)
        # "iou"
        return rotated_iou_loss(
            self._decode(anchors, bbox_preds).reshape(-1, 5), targets.reshape(-1, 5),
            weight=w1, mode=cfg.get("mode", "log"), avg_factor=num_total)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, outs, targets=None):
        """Fixed-shape batched detection at `self.test_cfg`.

        Returns a dict of polys (B, max_per_img, 8), boxes
        (B, max_per_img, 5), scores, labels (0-based fg, -1 where
        invalid) and valid."""
        cfg = self.test_cfg
        nms_pre = cfg["nms_pre"]
        level_scores, level_boxes = [], []
        for lvl, out in enumerate(outs):
            cls = out[0]
            b = cls.shape[0]
            scores = torch.sigmoid(self._nhwc(cls.float(), b, self.cls_out_channels))
            deltas = self._predict_deltas(out, b)
            anchors = self.anchor_generators[lvl].grid_anchors(
                tuple(cls.shape[-2:]), self.anchor_strides[lvl],
                device=cls.device,
            )
            n_lvl = anchors.shape[0]
            if 0 < nms_pre < n_lvl:
                _, topk = scores.amax(-1).topk(nms_pre, dim=-1)
                scores = torch.gather(
                    scores, 1, topk[..., None].expand(-1, -1, scores.shape[-1])
                )
                deltas = torch.gather(deltas, 1, topk[..., None].expand(-1, -1, 5))
                anchors_b = anchors[topk]
            else:
                anchors_b = anchors.expand(b, n_lvl, 5)
            level_scores.append(scores)
            level_boxes.append(
                delta2rbox(anchors_b, deltas, self.target_means, self.target_stds)
            )

        all_scores = torch.cat(level_scores, 1)
        all_boxes = torch.cat(level_boxes, 1)
        if targets is not None and "scale_factor" in targets:
            sf = targets["scale_factor"].reshape(-1, 1, 1).to(all_boxes)
            all_boxes = torch.cat([all_boxes[..., :4] / sf, all_boxes[..., 4:]], -1)

        det = multiclass_nms_rotated(
            all_boxes,
            all_scores,
            score_thr=cfg["score_thr"],
            nms_iou_thr=cfg["nms_iou_thr"],
            max_per_img=cfg["max_per_img"],
        )
        det["polys"] = rbox_to_poly(det["boxes"])
        return det


@HEADS.register_module()
class GWDRetinaHead(RotatedRetinaHead):
    """The GWD loss on decoded boxes."""

    def __init__(self, *a, loss_bbox=None, **kw):
        super().__init__(*a, loss_bbox=loss_bbox or dict(type="gwd", tau=1.0, loss_weight=1.0),
                         **kw)


@HEADS.register_module()
class KLDRetinaHead(RotatedRetinaHead):
    """The KLD loss on decoded boxes."""

    def __init__(self, *a, loss_bbox=None, **kw):
        super().__init__(*a, loss_bbox=loss_bbox or dict(type="kld", tau=1.0, loss_weight=1.0),
                         **kw)


@HEADS.register_module()
class KFIoURRetinaHead(RotatedRetinaHead):
    """The KFIoU loss."""

    def __init__(self, *a, loss_bbox=None, **kw):
        super().__init__(*a, loss_bbox=loss_bbox or dict(type="kfiou", loss_weight=1.0), **kw)


@HEADS.register_module()
class RotatedATSSHead(RotatedRetinaHead):
    """The ATSS assigner (top 9 center-nearest anchors of each level as
    candidates), usually with one anchor per location."""

    def __init__(self, *a, train_cfg=None, **kw):
        tc = dict(train_cfg or {})
        tc.setdefault("assigner", dict(type="atss", topk=9))
        super().__init__(*a, train_cfg=tc, **kw)


@HEADS.register_module()
class RSDetHead(RotatedRetinaHead):
    """RSDet's modulated loss."""

    def __init__(self, *a, loss_bbox=None, **kw):
        super().__init__(*a, loss_bbox=loss_bbox or dict(type="rsdet", sigma=3.0,
                                                         loss_weight=1.0), **kw)
