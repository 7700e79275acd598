"""S2ANet head: the Feature Alignment Module and the Oriented Detection
Module.

Port of `jdet_tpu/models/heads/s2anet_head.py` (`AlignConv` :61 with
`get_offset` :74, `S2ANetHead` :114, `forward_single` :224, `loss` :289
with the smooth-L1 and the RIDet branch, `predict` :377):

- FAM: conv towers -> fam_cls / fam_reg over one square anchor per
  location (`AnchorGeneratorRotatedS2ANet`); the detached FAM deltas
  decode the init anchors into per-image refined anchors
  (`wh_ratio_clip=1e-6`).
- AlignConv: a 3x3 deformable conv whose offsets move each tap to the
  matching point of the refined anchor, computed without gradient.
- ODM: ORConv2d (1 -> 8 orientations) and, for the class branch,
  rotation-invariant pooling; then towers -> odm_cls / odm_reg.
- Losses: targets twice, FAM on the shared init anchors and ODM on the
  per-image refined anchors (the fused assigner's two launches per step),
  each focal + smooth-L1 averaged by its own positive count. A stage
  whose box loss is `ridet` (`s2anet_r50_fpn_1x_dota_ridet.py`'s ODM)
  takes the gts themselves as targets (`reg_decoded_bbox`, from the
  stage's cfg, true by default under `ridet`) and scores its deltas
  decoded on its anchors with `ridet_loss`.
- `predict` decodes the ODM outputs from the refined anchors and runs the
  rotated NMS, whose per-class IoU runs on K1's matrix on the card.

Head outputs per level: fam_cls (B, C, H, W), fam_reg (B, 5, H, W), the
refined anchors (B, H, W, 5), odm_cls (B, C, H, W), odm_reg (B, 5, H, W).
Under the bf16 policy (`models/nn.py`) the towers and the output convs
compute in bf16; the refined anchors are float32 (float32 init anchors
decoded in float32 with the bf16 deltas' values); the deformable conv
returns float32, so the ORConv runs in float32; the ODM towers return to
bf16. `loss` and `predict` cast the outputs to float32 first (:290,
:380).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_convert import delta2rbox, rbox_to_poly
from ...ops.deform_conv import DeformConv
from ...ops.nms_rotated import multiclass_nms_rotated
from ...ops.orn import ORConv2d, rotation_invariant_pooling
from ...ops.topk import stable_topk
from ...utils.registry import HEADS
from ..boxes.anchor_generator import AnchorGeneratorRotatedS2ANet
from ..boxes.anchor_target import anchor_target_batch
from ..layers import Conv2d, ConvModule, bias_init_with_prob, normal_init
from ..losses import ridet_loss, sigmoid_focal_loss, smooth_l1_loss

DEFAULT_TRAIN_CFG = dict(
    fam_cfg=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
                 pos_weight=-1),
    odm_cfg=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
                 pos_weight=-1),
)

DEFAULT_TEST_CFG = dict(nms_pre=2000, score_thr=0.05, nms_iou_thr=0.1, max_per_img=2000)


class AlignConv(nn.Module):
    """Anchor-guided deformable alignment, ReLU after the deformable
    conv."""

    def __init__(self, in_channels, out_channels, kernel_size=3, *, generator=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.deform_conv = DeformConv(in_channels, out_channels, kernel_size,
                                      generator=generator)

    @torch.no_grad()
    def get_offset(self, anchors, stride):
        """anchors (B, H, W, 5) -> offsets (B, H, W, k * k, 2) as (dy, dx):
        tap (i, j) moves from (y + i, x + j) to the point (j * w / k,
        i * h / k) of the anchor's frame, in feature-map units."""
        k = self.kernel_size
        pad = (k - 1) // 2
        idx = torch.arange(-pad, pad + 1, dtype=anchors.dtype, device=anchors.device)
        yy, xx = torch.meshgrid(idx, idx, indexing="ij")
        xx = xx.reshape(-1)
        yy = yy.reshape(-1)
        B, H, W, _ = anchors.shape
        xc = torch.arange(W, dtype=anchors.dtype, device=anchors.device)
        yc = torch.arange(H, dtype=anchors.dtype, device=anchors.device)
        x_conv = xc[None, :, None] + xx[None, None, :]  # (1, W, kk)
        y_conv = yc[:, None, None] + yy[None, None, :]  # (H, 1, kk)
        ax, ay, aw, ah = (anchors[..., i] / stride for i in range(4))
        cos = torch.cos(anchors[..., 4])[..., None]
        sin = torch.sin(anchors[..., 4])[..., None]
        x = (aw / k)[..., None] * xx
        y = (ah / k)[..., None] * yy
        x_anchor = cos * x - sin * y + ax[..., None]
        y_anchor = sin * x + cos * y + ay[..., None]
        return torch.stack([y_anchor - y_conv[None], x_anchor - x_conv[None]], -1)

    def forward(self, x, anchors, stride):
        return F.relu(self.deform_conv(x, self.get_offset(anchors, stride)))


@HEADS.register_module()
class S2ANetHead(nn.Module):
    def __init__(
        self,
        num_classes,
        in_channels,
        feat_channels=256,
        stacked_convs=2,
        anchor_ratios=(1.0,),
        anchor_strides=(8, 16, 32, 64, 128),
        anchor_scales=(4,),
        anchor_base_sizes=None,
        target_means=(0.0,) * 5,
        target_stds=(1.0,) * 5,
        loss_fam_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
        loss_fam_bbox=dict(beta=1.0 / 9.0, loss_weight=1.0),
        loss_odm_cls=dict(gamma=2.0, alpha=0.25, loss_weight=1.0),
        loss_odm_bbox=dict(beta=1.0 / 9.0, loss_weight=1.0),
        train_cfg=None,
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.cls_out_channels = num_classes - 1
        self.anchor_strides = tuple(anchor_strides)
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.loss_cfgs = dict(fam_cls=dict(loss_fam_cls), fam_bbox=dict(loss_fam_bbox),
                              odm_cls=dict(loss_odm_cls), odm_bbox=dict(loss_odm_bbox))
        for name in ("fam_bbox", "odm_bbox"):
            kind = self.loss_cfgs[name].get("type", "smooth_l1")
            if kind not in ("smooth_l1", "ridet"):
                raise NotImplementedError(
                    f"loss_{name} {kind!r}: S2ANet's box losses are smooth_l1 and ridet")
        self.train_cfg = {**DEFAULT_TRAIN_CFG, **(train_cfg or {})}
        self.test_cfg = {**DEFAULT_TEST_CFG, **(test_cfg or {})}

        base_sizes = list(anchor_strides) if anchor_base_sizes is None else anchor_base_sizes
        self.anchor_generators = [
            AnchorGeneratorRotatedS2ANet(bs, scales=anchor_scales, ratios=anchor_ratios)
            for bs in base_sizes
        ]

        def towers(first_ch):
            return nn.ModuleList([
                ConvModule(first_ch if i == 0 else feat_channels, feat_channels, 3,
                           kernel_init=normal_init(0.01), generator=generator)
                for i in range(stacked_convs)
            ])

        def out_conv(channels, kernel, bias_value=0.0):
            return Conv2d(feat_channels, channels, kernel, kernel_init=normal_init(0.01),
                          bias_value=bias_value, generator=generator)

        prior = bias_init_with_prob(0.01)
        self.fam_reg_convs = towers(in_channels)
        self.fam_cls_convs = towers(in_channels)
        self.fam_reg = out_conv(5, 1)
        self.fam_cls = out_conv(self.cls_out_channels, 1, prior)
        self.align_conv = AlignConv(feat_channels, feat_channels, 3, generator=generator)
        self.or_conv = ORConv2d(feat_channels, feat_channels // 8, 3, (1, 8),
                                generator=generator)
        self.odm_reg_convs = towers(feat_channels)
        self.odm_cls_convs = towers(feat_channels // 8)
        self.odm_cls = out_conv(self.cls_out_channels, 3, prior)
        self.odm_reg = out_conv(5, 3)

    # ------------------------------------------------------------------
    def forward_single(self, x, level):
        stride = self.anchor_strides[level]
        B, _, H, W = x.shape
        fam_reg_feat = x
        for conv in self.fam_reg_convs:
            fam_reg_feat = conv(fam_reg_feat)
        fam_bbox_pred = self.fam_reg(fam_reg_feat)
        fam_cls_feat = x
        for conv in self.fam_cls_convs:
            fam_cls_feat = conv(fam_cls_feat)
        fam_cls_score = self.fam_cls(fam_cls_feat)

        init_anchors = self.anchor_generators[level].grid_anchors((H, W), stride,
                                                                  device=x.device)
        # the decode in float32 on the deltas' values: XLA, which keeps
        # excess precision in fused elementwise chains, decodes the
        # reference's bf16 deltas so (no bf16 rounding of exp(dw) or of
        # the offsets)
        deltas = fam_bbox_pred.detach().float().permute(0, 2, 3, 1).reshape(B, H * W, 5)
        refine_anchor = delta2rbox(init_anchors[None], deltas, self.target_means,
                                   self.target_stds, wh_ratio_clip=1e-6).reshape(B, H, W, 5)

        or_feat = self.or_conv(self.align_conv(x, refine_anchor, stride))
        odm_reg_feat = or_feat
        odm_cls_feat = rotation_invariant_pooling(or_feat, 8)
        for conv in self.odm_reg_convs:
            odm_reg_feat = conv(odm_reg_feat)
        for conv in self.odm_cls_convs:
            odm_cls_feat = conv(odm_cls_feat)
        return (fam_cls_score, fam_bbox_pred, refine_anchor, self.odm_cls(odm_cls_feat),
                self.odm_reg(odm_reg_feat))

    def forward(self, feats):
        """[(fam_cls, fam_reg, refined anchors, odm_cls, odm_reg)] per
        level."""
        return [self.forward_single(f, lvl) for lvl, f in enumerate(feats)]

    # ------------------------------------------------------------------
    def _flat_init_anchors(self, featmap_sizes, device):
        return torch.cat([
            gen.grid_anchors(tuple(fs), s, device=device)
            for gen, fs, s in zip(self.anchor_generators, featmap_sizes, self.anchor_strides)
        ], 0)

    def loss(self, outs, targets):
        """The four losses from head outputs. targets: gt_bboxes (B, K, 5),
        gt_labels (B, K) 1-based, gt_mask (B, K) bool."""
        outs = [tuple(t.float() for t in o) for o in outs]
        featmap_sizes = [o[0].shape[-2:] for o in outs]
        B = outs[0][0].shape[0]
        C = self.cls_out_channels

        def nhwc(i, c):
            return torch.cat([o[i].permute(0, 2, 3, 1).reshape(B, -1, c) for o in outs], 1)

        fam_cls, fam_reg, odm_cls, odm_reg = nhwc(0, C), nhwc(1, 5), nhwc(3, C), nhwc(4, 5)
        refine = torch.cat([o[2].reshape(B, -1, 5) for o in outs], 1)
        init_anchors = self._flat_init_anchors(featmap_sizes, fam_cls.device)
        valid = torch.ones(init_anchors.shape[0], dtype=torch.bool, device=fam_cls.device)
        gt_bboxes = targets["gt_bboxes"].float()
        gt_mask = targets["gt_mask"].bool()

        losses = {}
        for name, anchors, cls_p, reg_p in (("fam", init_anchors, fam_cls, fam_reg),
                                            ("odm", refine, odm_cls, odm_reg)):
            cfg = self.train_cfg[f"{name}_cfg"]
            bcfg = self.loss_cfgs[f"{name}_bbox"]
            bkind = bcfg.get("type", "smooth_l1")
            tgt, num_pos, _ = anchor_target_batch(
                anchors, valid, gt_bboxes, gt_mask, targets["gt_labels"],
                target_means=self.target_means, target_stds=self.target_stds,
                assigner_cfg=dict(cfg["assigner"]), pos_weight=cfg.get("pos_weight", -1),
                reg_decoded_bbox=bool(cfg.get("reg_decoded_bbox", bkind == "ridet")),
            )
            num_total = num_pos.clamp(min=1).to(cls_p.dtype)
            ccfg = self.loss_cfgs[f"{name}_cls"]
            losses[f"loss_{name}_cls"] = sigmoid_focal_loss(
                cls_p, tgt["labels"], weight=tgt["label_weights"],
                gamma=ccfg.get("gamma", 2.0), alpha=ccfg.get("alpha", 0.25),
                avg_factor=num_total,
            ) * ccfg.get("loss_weight", 1.0)
            if bkind == "ridet":
                # the deltas decoded on the anchors (the ODM's refined
                # anchors carry no gradient), against the gts themselves
                decoded = delta2rbox(anchors if anchors.dim() == 3 else anchors[None], reg_p,
                                     self.target_means, self.target_stds)
                loss_bbox = ridet_loss(
                    decoded.reshape(-1, 5), tgt["bbox_targets"].reshape(-1, 5),
                    weight=tgt["bbox_weights"][..., 0].reshape(-1),
                    beta=bcfg.get("beta", 1.0), avg_factor=num_total)
            else:
                loss_bbox = smooth_l1_loss(
                    reg_p, tgt["bbox_targets"], weight=tgt["bbox_weights"],
                    beta=bcfg.get("beta", 1.0 / 9.0), avg_factor=num_total)
            losses[f"loss_{name}_bbox"] = loss_bbox * bcfg.get("loss_weight", 1.0)
        return losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, outs, targets=None):
        """ODM detections decoded from the refined anchors, at
        `self.test_cfg`, in the fixed-size dict of
        `RotatedRetinaHead.predict`."""
        cfg = self.test_cfg
        nms_pre = cfg["nms_pre"]
        C = self.cls_out_channels
        level_scores, level_boxes = [], []
        for _, _, refine, cls, reg in outs:
            B = cls.shape[0]
            scores = torch.sigmoid(cls.float().permute(0, 2, 3, 1).reshape(B, -1, C))
            deltas = reg.float().permute(0, 2, 3, 1).reshape(B, -1, 5)
            anchors = refine.float().reshape(B, -1, 5)
            if 0 < nms_pre < anchors.shape[1]:
                _, topk = stable_topk(scores.amax(-1), nms_pre)
                scores = torch.gather(scores, 1, topk[..., None].expand(-1, -1, C))
                deltas = torch.gather(deltas, 1, topk[..., None].expand(-1, -1, 5))
                anchors = torch.gather(anchors, 1, topk[..., None].expand(-1, -1, 5))
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
