"""FasterRCNN-OBB's and Gliding Vertex's heads, the RoI-Transformer
cascade, Strip R-CNN's head and ReDet's head.

Port of `jdet_tpu/models/heads/obb_roi_heads.py` (`FasterrcnnHead` :45,
`GlidingHead` :115, `RoITransHead` :224, `StripHead` :415,
`_RiRoIExtractor` :446, `ReDetHead` :469), on `roi_head_base.py`.

`FasterrcnnHead` and `GlidingHead` work on the hbb RPN's proposals: each
image's gt hbbs prepended, `max_iou_assign_hbb` and the sampler
(`_sample_rois`), hbb RoI align, two shared FCs (1024), then

- `FasterrcnnHead`: `fc_cls` (classes + background) and `fc_reg`, 5
  deltas of the rotated gt against the RoI as a zero-angle rbox
  (`rbox2delta(hbox_to_rbox(roi), gt)`, stds 0.1, 0.1, 0.2, 0.2, 0.1);
  cross entropy and smooth-L1 (beta 1) over the sampled count;
  `predict` decodes the deltas from the proposals;
- `GlidingHead`: `fc_cls`, `fc_reg` (4 hbb deltas of the gt's enclosing
  hbb, stds 0.1, 0.1, 0.2, 0.2), `fc_fix` (the gt quad's 4 glide ratios
  along its hbb, through a sigmoid) and `fc_ratio` (its area over the
  hbb's, through a sigmoid); the fix and ratio losses are smooth-L1
  (beta 1/3) weighted by the positives, all four over the sampled count.
  `predict` decodes the hbb, glides its edges into a quad, keeps the hbb
  itself where the ratio exceeds `ratio_thr` (0.8), takes the quad's
  rbox (`poly_to_rbox`), and runs `_final_nms`.

Their class and box outputs stay in the compute dtype, as the
reference's do; `predict`'s scores are the compute dtype's softmax.

`StripHead` is `OrientedHead` with two depthwise strip convs, 1 x k then
k x 1 (k = 7, padded (0, 3) then (3, 0)), added as a residual to each
RoI's (P, P, C) features before the FCs, which still flatten them in
(y, x, c) order. The cascades:

- stage 1: the hbb proposals, each image's gt hbbs prepended, assigned by
  `max_iou_assign_hbb` and sampled; hbb RoI align (`SingleRoIExtractor`),
  two shared FCs, `fc_cls` and `fc_reg`; the positives regress their
  rotated gts as `rbox2delta(hbox_to_rbox(roi), gt)` (stds 0.1, 0.1, 0.2,
  0.2, 0.1);
- refinement: the sampled RoIs decoded by their stage-1 deltas into
  rotated RoIs, without gradient;
- stage 2: each image's rotated gts prepended to its refined RoIs (the
  gt masks and the stage-1 validity as per-image masks), the fused CUDA
  assigner (one launch for the batch) and the sampler; rotated RoI
  align with w, h enlarged by (1.2, 1.4) (`RoITransHead`) or RiRoIAlign
  (`ReDetHead`), two more shared FCs, `fc_cls2` and `fc_reg2`; targets
  `rbox2delta(roi, gt)` with stds 0.05, 0.05, 0.1, 0.1, 0.05;
- `predict`: both stages on the proposals, decoded twice, and the final
  NMS of the stage-2 scores.

The stage-1 class and box outputs stay in the compute dtype, as the
reference's do: its losses and the refinement see them so. The losses
are `loss_{cls,bbox}_s{1,2}`: cross entropy and smooth-L1 (beta 1), each
stage over its own sampled count. The samplers draw in the order stage-1
positives, stage-1 negatives, stage-2 positives, stage-2 negatives.
"""
from __future__ import annotations

import torch

from ...ops.box_convert import (delta2hbox, delta2rbox, hbox2delta, hbox_to_rbox,
                                poly_to_rbox, rbox2delta, rbox_to_hbox, rbox_to_poly)
from ...ops.riroi_align import riroi_align_multilevel
from ...utils.registry import HEADS
from ..boxes.coder import gv_fix_decode, gv_fix_encode, gv_ratio_encode
from ..layers import Conv2d, Linear, at_least_float32, normal_init, sigmoid
from ..losses import cross_entropy_loss, smooth_l1_loss
from ..roi_extractors import OrientedSingleRoIExtractor
from ..roi_extractors.single_level import _map_levels
from .oriented_head import OrientedHead
from .roi_head_base import RoIHeadBase, shared_fcs


class _HbbHead(RoIHeadBase):
    """What FasterRCNN-OBB's and Gliding Vertex's heads share: hbb
    proposals, the shared FCs and `fc_cls`."""

    start_bbox_type = "hbb"

    def _sample(self, proposals, targets, rand, generator):
        """`_sample_rois` on the gt hbbs, regressing the rotated gts."""
        return self._sample_rois(
            proposals["boxes"], proposals["valid"], targets["gt_hboxes"].float(),
            targets["gt_mask"].bool(), targets["gt_labels"], rand=rand, generator=generator,
            gt_reg=targets["gt_bboxes"].float())

    def _cls_losses(self, cls_score, bbox_pred, lw, labels, bt, bw):
        avg = (lw > 0).sum().clamp(min=1).float()
        return avg, {
            "loss_cls": cross_entropy_loss(cls_score, labels, weight=lw, avg_factor=avg),
            "loss_bbox": smooth_l1_loss(bbox_pred, bt, weight=bw, beta=1.0, avg_factor=avg),
        }

    def _scores(self, x, valid):
        """The foreground classes' softmax, in the compute dtype's values,
        zero on invalid proposals."""
        scores = torch.softmax(self.fc_cls(x), -1)[..., :self.num_classes]
        return scores.float() * valid[..., None]


@HEADS.register_module()
class FasterrcnnHead(_HbbHead):
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
        train_cfg=None,
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self._init_common(num_classes, in_channels, fc_out_channels, num_shared_fcs, roi_size,
                          featmap_strides, train_cfg, test_cfg, generator=generator)
        self.fc_cls = Linear(fc_out_channels, num_classes + 1, kernel_init=normal_init(0.01),
                             generator=generator)
        self.fc_reg = Linear(fc_out_channels, 5, kernel_init=normal_init(0.001),
                             generator=generator)

    def _encode(self, rois, gts):
        return rbox2delta(hbox_to_rbox(rois), gts, self.target_means, self.target_stds)

    def loss(self, feats, proposals, targets, rand=None, generator=None):
        """CE and smooth-L1 on the RPN's (detached) hbb proposals. The
        sampler draws from `rand` or `generator`."""
        rois, valid, labels, lw, bt, bw, _ = self._sample(proposals, targets, rand, generator)
        x = self._shared_forward(feats, rois, valid)
        return self._cls_losses(self.fc_cls(x), self.fc_reg(x), lw, labels, bt, bw)[1]

    @torch.no_grad()
    def predict(self, feats, proposals, targets=None):
        rois, valid = proposals["boxes"], proposals["valid"]
        x = self._shared_forward(feats, rois, valid)
        boxes = delta2rbox(hbox_to_rbox(rois), self.fc_reg(x), self.target_means,
                           self.target_stds)
        return self._final_nms(boxes, self._scores(x, valid), targets)


@HEADS.register_module()
class GlidingHead(_HbbHead):
    def __init__(
        self,
        num_classes=15,
        in_channels=256,
        fc_out_channels=1024,
        num_shared_fcs=2,
        roi_size=7,
        featmap_strides=(4, 8, 16, 32),
        target_means=(0.0,) * 4,
        target_stds=(0.1, 0.1, 0.2, 0.2),
        ratio_thr=0.8,
        train_cfg=None,
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.ratio_thr = ratio_thr
        self._init_common(num_classes, in_channels, fc_out_channels, num_shared_fcs, roi_size,
                          featmap_strides, train_cfg, test_cfg, generator=generator)
        self.fc_cls = Linear(fc_out_channels, num_classes + 1, kernel_init=normal_init(0.01),
                             generator=generator)
        self.fc_reg = Linear(fc_out_channels, 4, kernel_init=normal_init(0.001),
                             generator=generator)
        self.fc_fix = Linear(fc_out_channels, 4, kernel_init=normal_init(0.001),
                             generator=generator)
        self.fc_ratio = Linear(fc_out_channels, 1, kernel_init=normal_init(0.001),
                               generator=generator)

    def _encode(self, rois, gts):
        return hbox2delta(rois, rbox_to_hbox(gts), self.target_means, self.target_stds)

    def loss(self, feats, proposals, targets, rand=None, generator=None):
        """The class, hbb, glide and ratio losses on the RPN's (detached)
        hbb proposals. The sampler draws from `rand` or `generator`."""
        rois, valid, labels, lw, bt, bw, matched = self._sample(proposals, targets, rand,
                                                                generator)
        x = self._shared_forward(feats, rois, valid)
        fix_pred = sigmoid(self.fc_fix(x))
        ratio_pred = sigmoid(self.fc_ratio(x))
        gt_poly = rbox_to_poly(matched)
        gt_hbb = rbox_to_hbox(matched)
        avg, losses = self._cls_losses(self.fc_cls(x), self.fc_reg(x), lw, labels, bt, bw)
        pw = bw[..., :1]
        pos = pw > 0
        losses["loss_fix"] = smooth_l1_loss(
            fix_pred, torch.where(pos, gv_fix_encode(gt_hbb, gt_poly), 0.0), weight=pw,
            beta=1.0 / 3.0, avg_factor=avg)
        losses["loss_ratio"] = smooth_l1_loss(
            ratio_pred, torch.where(pos, gv_ratio_encode(gt_hbb, gt_poly), 0.0), weight=pw,
            beta=1.0 / 3.0, avg_factor=avg)
        return losses

    @torch.no_grad()
    def predict(self, feats, proposals, targets=None):
        rois, valid = proposals["boxes"], proposals["valid"]
        x = self._shared_forward(feats, rois, valid)
        hbb = delta2hbox(rois, self.fc_reg(x), self.target_means, self.target_stds)
        polys = gv_fix_decode(hbb, sigmoid(self.fc_fix(x)))
        ratio = sigmoid(self.fc_ratio(x))[..., 0]
        # near-horizontal objects (ratio near 1) keep the hbb
        x1, y1, x2, y2 = hbb.unbind(-1)
        hpoly = torch.stack([x1, y1, x2, y1, x2, y2, x1, y2], -1)
        polys = torch.where((ratio > self.ratio_thr)[..., None], hpoly, polys)
        return self._final_nms(poly_to_rbox(polys), self._scores(x, valid), targets)


@HEADS.register_module()
class StripHead(OrientedHead):
    def __init__(self, *args, strip_k=7, in_channels=256, generator=None, **kw):
        super().__init__(*args, in_channels=in_channels, generator=generator, **kw)
        pad = strip_k // 2
        self.strip_h = Conv2d(in_channels, in_channels, (1, strip_k), padding=(0, pad),
                              groups=in_channels, generator=generator)
        self.strip_v = Conv2d(in_channels, in_channels, (strip_k, 1), padding=(pad, 0),
                              groups=in_channels, generator=generator)

    def _forward_rois(self, feats, rois, valid):
        x = self.roi_extractor(feats, rois, valid)  # (B, S, P, P, C)
        B, S, P, _, C = x.shape
        xs = x.reshape(B * S, P, P, C).permute(0, 3, 1, 2)
        xs = xs + self.strip_v(self.strip_h(xs))
        x = xs.permute(0, 2, 3, 1).reshape(B, S, -1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return at_least_float32(self.fc_cls(x)), at_least_float32(self.fc_reg(x))


class RiRoIExtractor:
    """Rotated RoIs (B, R, 5) -> RiRoIAlign features (B, R, P, P, C), each
    RoI on the level of its own size."""

    def __init__(self, out_size=7, featmap_strides=(4, 8, 16, 32), finest_scale=56):
        self.out_size = out_size
        self.featmap_strides = tuple(featmap_strides)
        self.finest_scale = finest_scale

    def __call__(self, feats, rois, valid=None):
        num_levels = len(self.featmap_strides)
        scale = torch.sqrt((rois[..., 2] * rois[..., 3]).clamp(min=1e-6))
        lvl = _map_levels(scale, num_levels, self.finest_scale)
        return riroi_align_multilevel(feats[:num_levels], rois, lvl, self.featmap_strides,
                                      self.out_size, 2, valid=valid)


@HEADS.register_module()
class RoITransHead(RoIHeadBase):
    start_bbox_type = "hbb"

    def __init__(
        self,
        num_classes=15,
        in_channels=256,
        fc_out_channels=1024,
        roi_size=7,
        featmap_strides=(4, 8, 16, 32),
        stage1_target_stds=(0.1, 0.1, 0.2, 0.2, 0.1),
        stage2_target_stds=(0.05, 0.05, 0.1, 0.1, 0.05),
        extend_factor=(1.2, 1.4),
        train_cfg=None,
        test_cfg=None,
        *,
        generator=None,
    ):
        super().__init__()
        self.target_means = (0.0,) * 5
        self.target_stds = tuple(stage1_target_stds)
        self.stage2_target_stds = tuple(stage2_target_stds)
        self._init_common(num_classes, in_channels, fc_out_channels, 2, roi_size,
                          featmap_strides, train_cfg, test_cfg, generator=generator)
        self.fc_cls = Linear(fc_out_channels, num_classes + 1, kernel_init=normal_init(0.01),
                             generator=generator)
        self.fc_reg = Linear(fc_out_channels, 5, kernel_init=normal_init(0.001),
                             generator=generator)
        self.roi_extractor2 = self._stage2_extractor(roi_size, featmap_strides, extend_factor)
        self.shared_fcs2 = shared_fcs(in_channels * roi_size * roi_size, fc_out_channels, 2,
                                      generator)
        self.fc_cls2 = Linear(fc_out_channels, num_classes + 1, kernel_init=normal_init(0.01),
                              generator=generator)
        self.fc_reg2 = Linear(fc_out_channels, 5, kernel_init=normal_init(0.001),
                              generator=generator)

    @staticmethod
    def _stage2_extractor(roi_size, featmap_strides, extend_factor):
        return OrientedSingleRoIExtractor(out_size=roi_size, featmap_strides=featmap_strides,
                                          extend_factor=extend_factor)

    def _encode(self, rois, gts):
        return rbox2delta(hbox_to_rbox(rois), gts, self.target_means, self.target_stds)

    def _encode2(self, rois, gts):
        return rbox2delta(rois, gts, self.target_means, self.stage2_target_stds)

    def _refine(self, rois, reg1):
        """Stage-1 hbb RoIs and their deltas -> rotated RoIs."""
        return delta2rbox(hbox_to_rbox(rois), reg1, self.target_means, self.target_stds)

    def _stage1_forward(self, feats, rois, valid):
        x = self._shared_forward(feats, rois, valid)
        return self.fc_cls(x), self.fc_reg(x)

    def _stage2_forward(self, feats, rois, valid):
        x = self.roi_extractor2(feats, rois, valid)
        x = x.reshape(*x.shape[:2], -1)
        for fc in self.shared_fcs2:
            x = torch.relu(fc(x))
        return at_least_float32(self.fc_cls2(x)), at_least_float32(self.fc_reg2(x))

    @staticmethod
    def _stage_losses(cls, reg, labels, lw, bt, bw, stage):
        avg = (lw > 0).sum().clamp(min=1).float()
        return {f"loss_cls_s{stage}": cross_entropy_loss(cls, labels, weight=lw, avg_factor=avg),
                f"loss_bbox_s{stage}": smooth_l1_loss(reg, bt, weight=bw, beta=1.0,
                                                      avg_factor=avg)}

    def loss(self, feats, proposals, targets, rand=None, generator=None):
        """The four losses of the cascade on the RPN's (detached) hbb
        proposals. targets: gt_bboxes, gt_hboxes, gt_mask, gt_labels. The
        samplers draw from `rand` or `generator`."""
        gt_bboxes = targets["gt_bboxes"].float()
        gt_mask = targets["gt_mask"].bool()
        gt_labels = targets["gt_labels"]
        rois, valid, *s1, _ = self._sample_rois(
            proposals["boxes"], proposals["valid"], targets["gt_hboxes"].float(), gt_mask,
            gt_labels, rand=rand, generator=generator, gt_reg=gt_bboxes)
        cls1, reg1 = self._stage1_forward(feats, rois, valid)
        losses = self._stage_losses(cls1, reg1, *s1, stage=1)
        with torch.no_grad():
            refined = self._refine(rois, reg1)
        rois2, valid2, *s2, _ = self._sample_rois(
            refined, valid, gt_bboxes, gt_mask, gt_labels, rand=rand, generator=generator,
            rotated=True, encode=self._encode2)
        cls2, reg2 = self._stage2_forward(feats, rois2, valid2)
        losses.update(self._stage_losses(cls2, reg2, *s2, stage=2))
        return losses

    @torch.no_grad()
    def predict(self, feats, proposals, targets=None):
        rois, valid = proposals["boxes"], proposals["valid"]
        refined = self._refine(rois, self._stage1_forward(feats, rois, valid)[1])
        cls2, reg2 = self._stage2_forward(feats, refined, valid)
        scores = torch.softmax(cls2, -1)[..., :self.num_classes] * valid[..., None]
        boxes = delta2rbox(refined, reg2, self.target_means, self.stage2_target_stds)
        return self._final_nms(boxes, scores, targets)


@HEADS.register_module()
class ReDetHead(RoITransHead):
    """The RoI-Transformer cascade whose second stage aligns with
    RiRoIAlign (no enlargement)."""

    @staticmethod
    def _stage2_extractor(roi_size, featmap_strides, extend_factor):
        return RiRoIExtractor(out_size=roi_size, featmap_strides=featmap_strides)
