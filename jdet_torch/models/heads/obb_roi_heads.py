"""The RoI-Transformer cascade and ReDet's head.

Port of `jdet_tpu/models/heads/obb_roi_heads.py` (`RoITransHead` :224,
`_RiRoIExtractor` :446, `ReDetHead` :469), on `roi_head_base.py`:

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

from ...ops.box_convert import delta2rbox, hbox_to_rbox, rbox2delta
from ...ops.riroi_align import riroi_align_multilevel
from ...utils.registry import HEADS
from ..layers import Linear, normal_init
from ..losses import cross_entropy_loss, smooth_l1_loss
from ..roi_extractors import OrientedSingleRoIExtractor
from ..roi_extractors.single_level import _map_levels
from .roi_head_base import RoIHeadBase, shared_fcs


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
        return self.fc_cls2(x).float(), self.fc_reg2(x).float()

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
        rois, valid, *s1 = self._sample_rois(
            proposals["boxes"], proposals["valid"], targets["gt_hboxes"].float(), gt_mask,
            gt_labels, rand=rand, generator=generator, gt_reg=gt_bboxes)
        cls1, reg1 = self._stage1_forward(feats, rois, valid)
        losses = self._stage_losses(cls1, reg1, *s1, stage=1)
        with torch.no_grad():
            refined = self._refine(rois, reg1)
        rois2, valid2, *s2 = self._sample_rois(
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
