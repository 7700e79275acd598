"""What the two-stage RoI heads share: sampling, the shared FCs, the
final NMS.

Port of `jdet_tpu/models/heads/roi_head_base.py::RoIHeadBase` (:47;
`_sample_rois` :141 over a leading batch dimension, which is the
reference's `sample_batch` :197 vmap written out; `_final_nms` :209). A
head chooses the space its proposals live in (`start_bbox_type`, "hbb"
or "obb") and its target codec (`_encode`).

- `_sample_rois`: each image's gts (in the proposals' space) are
  prepended to its proposals, with their own masks; the max-IoU
  assignment (0.5 / 0.5 / 0.5, no low-quality match) is the plain
  PyTorch `max_iou_assign_hbb` for hbb proposals and the fused CUDA
  assigner `max_iou_assign_rotated` for rotated ones (one launch for the
  batch, per-image candidates and masks); a random sampler keeps `num`
  RoIs (at most a quarter positive), moved to the front with the
  positives first (a stable sort); the positives regress their gts in
  the regression space (rotated gts) through `_encode`.
- `_shared_forward`: (B, S, 7, 7, C) features flattened in (y, x, c)
  order through the shared FCs (ReLU), cast to float32.
- `_final_nms`: boxes divided by the scale factor, then
  `multiclass_nms_rotated` (its per-class IoU on K1's matrix on the
  card) and the polygons.

Labels: 0-based classes, background = num_classes (the last logit).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_convert import rbox_to_poly
from ...ops.nms_rotated import multiclass_nms_rotated
from ..boxes.assigner import max_iou_assign_hbb, max_iou_assign_rotated
from ..boxes.sampler import random_sample
from ..layers import Linear, xavier_uniform_init
from ..roi_extractors import OrientedSingleRoIExtractor, SingleRoIExtractor

DEFAULT_ROI_TRAIN_CFG = dict(
    assigner=dict(
        pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
        match_low_quality=False,
    ),
    sampler=dict(num=512, pos_fraction=0.25, neg_pos_ub=-1,
                 add_gt_as_proposals=True),
    pos_weight=-1,
)

DEFAULT_ROI_TEST_CFG = dict(score_thr=0.05, nms_iou_thr=0.1, max_per_img=2000)


def shared_fcs(in_dim, fc_out_channels, n, generator=None):
    return nn.ModuleList([
        Linear(in_dim if i == 0 else fc_out_channels, fc_out_channels,
               kernel_init=xavier_uniform_init, generator=generator)
        for i in range(n)
    ])


class RoIHeadBase(nn.Module):
    start_bbox_type = "obb"

    def _init_common(self, num_classes, in_channels, fc_out_channels, num_shared_fcs,
                     roi_size, featmap_strides, train_cfg, test_cfg, extend_factor=(1.0, 1.0),
                     generator=None):
        self.num_classes = num_classes
        self.train_cfg = {**DEFAULT_ROI_TRAIN_CFG, **(train_cfg or {})}
        self.test_cfg = {**DEFAULT_ROI_TEST_CFG, **(test_cfg or {})}
        if self.start_bbox_type == "obb":
            self.roi_extractor = OrientedSingleRoIExtractor(
                out_size=roi_size, featmap_strides=featmap_strides, extend_factor=extend_factor)
        else:
            self.roi_extractor = SingleRoIExtractor(out_size=roi_size,
                                                    featmap_strides=featmap_strides)
        self.shared_fcs = shared_fcs(in_channels * roi_size * roi_size, fc_out_channels,
                                     num_shared_fcs, generator)

    def _encode(self, rois, gts):
        raise NotImplementedError

    def _shared_forward(self, feats, rois, valid):
        x = self.roi_extractor(feats, rois, valid)
        x = x.reshape(*x.shape[:2], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return x.float()

    @torch.no_grad()
    def _sample_rois(self, proposals, p_valid, gt_assign, gt_mask, gt_labels, rand=None,
                     generator=None, *, gt_reg=None, rotated=None, encode=None):
        """Assign and sample each image's proposals (B, P, d) against its
        gts `gt_assign` (B, K, d) in the same space: rotated (d = 5) or
        horizontal (d = 4), by default as `start_bbox_type` says. The
        positives regress `gt_reg` (default gt_assign) through `encode`
        (default `self._encode`). The sampler draws from `rand` or
        `generator`. Returns rois (B, S, d), their validity, labels,
        label weights, box targets, box weights, and each RoI's matched gt
        in `gt_reg`'s space (zero where it is not a positive; the
        reference's `matched_gt`, which Gliding Vertex's glide and ratio
        targets read)."""
        cfg = self.train_cfg
        scfg = cfg["sampler"]
        rotated = self.start_bbox_type == "obb" if rotated is None else rotated
        gt_reg = gt_assign if gt_reg is None else gt_reg
        encode = encode or self._encode
        if scfg.get("add_gt_as_proposals", True):
            proposals = torch.cat([gt_assign, proposals], 1)
            p_valid = torch.cat([gt_mask, p_valid], 1)
        assign_fn = max_iou_assign_rotated if rotated else max_iou_assign_hbb
        assign = assign_fn(proposals.contiguous(), gt_assign, gt_mask, gt_labels,
                           anchor_mask=p_valid, **cfg["assigner"])
        sample = random_sample(assign, scfg["num"], scfg["pos_fraction"],
                               scfg.get("neg_pos_ub", -1), rand=rand, generator=generator)
        pos, neg = sample["pos_mask"], sample["neg_mask"]
        S = scfg["num"]
        # the sampled RoIs to the front, positives first
        priority = torch.where(pos, 2, torch.where(neg, 1, 0))
        order = torch.sort(priority, dim=-1, descending=True, stable=True).indices[:, :S]
        sel_valid = torch.gather(pos | neg, 1, order)
        d = proposals.shape[-1]
        rois = torch.gather(proposals, 1, order[..., None].expand(-1, -1, d))
        rois = torch.where(sel_valid[..., None], rois, 0.0)
        is_pos = torch.gather(pos, 1, order)
        k = gt_reg.shape[1]
        safe_gt = (torch.gather(assign["gt_inds"], 1, order) - 1).clamp(0, k - 1)
        matched = torch.gather(gt_reg, 1, safe_gt[..., None].expand(-1, -1, gt_reg.shape[-1]))
        enc = encode(rois, matched)
        bbox_targets = torch.where(is_pos[..., None], enc, 0.0)
        bbox_weights = is_pos[..., None].to(enc.dtype)
        labels = torch.where(is_pos, (torch.gather(assign["labels"], 1, order) - 1).clamp(min=0),
                             self.num_classes)
        label_weights = sel_valid.to(enc.dtype)
        return (rois, sel_valid, labels, label_weights, bbox_targets, bbox_weights,
                torch.where(is_pos[..., None], matched, 0.0))

    def _final_nms(self, boxes, scores, targets=None):
        """Detections in the fixed-size dict of `RotatedRetinaHead.predict`,
        at `self.test_cfg`."""
        if targets is not None and "scale_factor" in targets:
            sf = targets["scale_factor"].reshape(-1, 1, 1).to(boxes)
            boxes = torch.cat([boxes[..., :4] / sf, boxes[..., 4:]], -1)
        cfg = self.test_cfg
        det = multiclass_nms_rotated(boxes, scores, score_thr=cfg["score_thr"],
                                     nms_iou_thr=cfg["nms_iou_thr"],
                                     max_per_img=cfg["max_per_img"])
        det["polys"] = rbox_to_poly(det["boxes"])
        return det
