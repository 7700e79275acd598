"""Region proposal heads: the classic hbb RPN (ReDet, RoI-Transformer,
FasterRCNN-OBB), Gliding Vertex's RPN and the oriented RPN of Oriented
R-CNN.

Port of `jdet_tpu/models/heads/rpn_heads.py` (`_RPNBase` :46, `RPNHead`
:272, `GlidingRPNHead` :277, `OrientedRPNHead` :290): a shared 3x3 conv,
then 1x1 objectness and regression convs over horizontal anchors (3
ratios x 1 scale per location, `AnchorGeneratorHBB`). `RPNHead` and
`GlidingRPNHead` regress the 4 hbb deltas (`hbox2delta` against the gts'
enclosing hbbs) and propose hbbs; `OrientedRPNHead` regresses the 6
midpoint offsets of the rotated gts and proposes rotated boxes.

- `loss`: the anchors are assigned to the gts' enclosing hbbs by
  `max_iou_assign_hbb`, sampled at random (256 per image, half
  positives), and the positives regress their gts in the head's codec;
  BCE + smooth-L1 (beta 1/9), both over the sampled count.
- `get_proposals`: per level the `nms_pre` best anchors (a stable sort:
  ties go to the lower index, as `jax.lax.top_k` breaks them), decoded,
  the size filter, hbb NMS at `nms_thresh`, then the `nms_post` best
  kept boxes per image. `RPNHead` and `OrientedRPNHead` run the NMS
  within each level: levels never suppress each other, so the levels are
  padded with invalid slots to one (B, L, nms_pre) batch and one NMS
  sweep runs for all of them. `GlidingRPNHead` (`cross_level_nms`, NMS
  threshold 0.7 by default) runs one NMS per image over all levels'
  candidates together, a (B, sum of the levels' sizes) problem.

Head outputs per level: cls (B, A, H, W), reg (B, A * reg_dim, H, W), in
the compute dtype; `loss` and `get_proposals` cast them to float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.box_convert import delta2hbox, hbox2delta, rbox_to_hbox
from ...ops.nms import nms
from ...utils.registry import HEADS
from ..boxes.anchor_generator import AnchorGeneratorHBB
from ..boxes.anchor_target import anchor_target_batch
from ..boxes.coder import midpoint_offset_decode, midpoint_offset_encode
from ..layers import Conv2d, normal_init
from ..losses import binary_cross_entropy_loss, smooth_l1_loss

DEFAULT_RPN_TRAIN_CFG = dict(
    assigner=dict(
        pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
        match_low_quality=True,
    ),
    sampler=dict(type="random", num=256, pos_fraction=0.5, neg_pos_ub=-1),
    allowed_border=0,
    pos_weight=-1,
)


class _RPNBase(nn.Module):
    """The shared RPN; subclasses set `reg_dim` and `box_dim` and the
    codec hooks `_encode`, `_decode`, `_gt_for_reg`, `_proposal_hbb` and
    `_proposal_wh`."""

    reg_dim = 4
    box_dim = 4
    cross_level_nms = False

    def __init__(
        self,
        in_channels,
        feat_channels=256,
        anchor_scales=(8,),
        anchor_ratios=(0.5, 1.0, 2.0),
        anchor_strides=(4, 8, 16, 32, 64),
        target_means=None,
        target_stds=None,
        nms_pre=2000,
        nms_post=2000,
        nms_thresh=0.8,
        min_bbox_size=0,
        train_cfg=None,
        loss_weight=1.0,
        *,
        generator=None,
    ):
        super().__init__()
        self.anchor_strides = tuple(anchor_strides)
        self.anchor_generator = AnchorGeneratorHBB(anchor_strides, anchor_ratios, anchor_scales)
        self.num_anchors = self.anchor_generator.num_base_anchors
        self.target_means = tuple(target_means or (0.0,) * self.reg_dim)
        self.target_stds = tuple(target_stds or (1.0,) * self.reg_dim)
        self.nms_pre = nms_pre
        self.nms_post = nms_post
        self.nms_thresh = nms_thresh
        self.min_bbox_size = min_bbox_size
        self.loss_weight = loss_weight
        self.train_cfg = {**DEFAULT_RPN_TRAIN_CFG, **(train_cfg or {})}
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, kernel_init=normal_init(0.01),
                               generator=generator)
        self.rpn_cls = Conv2d(feat_channels, self.num_anchors, 1, kernel_init=normal_init(0.01),
                              generator=generator)
        self.rpn_reg = Conv2d(feat_channels, self.num_anchors * self.reg_dim, 1,
                              kernel_init=normal_init(0.01), generator=generator)

    def forward(self, feats):
        """[(cls, reg)] per level."""
        outs = []
        for x in feats:
            feat = F.relu(self.rpn_conv(x))
            outs.append((self.rpn_cls(feat), self.rpn_reg(feat)))
        return outs

    def _encode(self, anchors, gts):
        return hbox2delta(anchors, gts, self.target_means, self.target_stds)

    def _decode(self, anchors, deltas):
        return delta2hbox(anchors, deltas, self.target_means, self.target_stds)

    def _gt_for_reg(self, targets):
        return targets["gt_hboxes"]

    def _proposal_hbb(self, boxes):
        return boxes

    def _proposal_wh(self, boxes, hbb):
        """The widths and heights the size filter reads."""
        return hbb[..., 2] - hbb[..., 0], hbb[..., 3] - hbb[..., 1]

    def _level_anchors(self, outs):
        return [self.anchor_generator.grid_anchors(tuple(cls.shape[-2:]), lvl,
                                                   device=cls.device)
                for lvl, (cls, _) in enumerate(outs)]

    @staticmethod
    def _flat(t, d):
        """(B, A * d, H, W) -> (B, H * W * A, d), or (B, H * W * A) for d=1."""
        B = t.shape[0]
        t = t.float().permute(0, 2, 3, 1)
        return t.reshape(B, -1) if d == 1 else t.reshape(B, -1, d)

    def loss(self, outs, targets, rand=None, generator=None):
        """RPN losses. targets: gt_bboxes (B, K, 5), gt_hboxes (B, K, 4)
        (their enclosing hbbs), gt_mask (B, K). The sampler draws from
        `rand` or `generator` (`boxes/sampler.py::random_sample`); the
        positives regress `_gt_for_reg(targets)` in the head's codec."""
        B = outs[0][0].shape[0]
        anchors = torch.cat(self._level_anchors(outs), 0)
        n = anchors.shape[0]
        cls = torch.cat([self._flat(c, 1) for c, _ in outs], 1)
        reg = torch.cat([self._flat(r, self.reg_dim) for _, r in outs], 1)
        cfg = self.train_cfg
        gt_mask = targets["gt_mask"].bool()
        # class-agnostic: the assignment is on hbbs, every real gt class 1
        tgt, num_pos, num_neg = anchor_target_batch(
            anchors, torch.ones(n, dtype=torch.bool, device=cls.device),
            targets["gt_hboxes"].float(), gt_mask, gt_mask.long(),
            assigner_cfg=cfg["assigner"], sampler_cfg=cfg["sampler"],
            pos_weight=cfg.get("pos_weight", -1), rotated=False, reg_decoded_bbox=True,
            rand=rand, generator=generator,
        )
        num_total = (num_pos + num_neg).clamp(min=1).to(cls.dtype)
        loss_cls = binary_cross_entropy_loss(cls, tgt["labels"] > 0,
                                             weight=tgt["label_weights"], avg_factor=num_total)
        gt = self._gt_for_reg(targets).float()
        k, d = gt.shape[1:]
        safe = (tgt["gt_inds"] - 1).clamp(0, k - 1)
        matched = torch.gather(gt, 1, safe[..., None].expand(B, n, d))
        enc = self._encode(anchors.expand(B, n, 4), matched)
        pos = tgt["pos_mask"]
        loss_reg = smooth_l1_loss(reg, torch.where(pos[..., None], enc, 0.0),
                                  weight=pos.to(cls.dtype), beta=1.0 / 9.0,
                                  avg_factor=num_total)
        return {"loss_rpn_cls": loss_cls * self.loss_weight,
                "loss_rpn_bbox": loss_reg * self.loss_weight}

    @torch.no_grad()
    def get_proposals(self, outs):
        """Proposals per image: boxes (B, nms_post, box_dim) (zero where
        invalid), scores (B, nms_post) and valid (B, nms_post)."""
        B = outs[0][0].shape[0]
        level_boxes, level_scores, sizes = [], [], []
        for (cls, reg), anchors in zip(outs, self._level_anchors(outs)):
            scores = torch.sigmoid(self._flat(cls, 1))
            deltas = self._flat(reg, self.reg_dim)
            n_lvl = anchors.shape[0]
            if 0 < self.nms_pre < n_lvl:
                scores, top = torch.sort(scores, dim=-1, descending=True, stable=True)
                scores, top = scores[:, :self.nms_pre], top[:, :self.nms_pre]
                deltas = torch.gather(deltas, 1, top[..., None].expand(-1, -1, self.reg_dim))
                anchors = anchors[top]
            else:
                anchors = anchors.expand(B, n_lvl, 4)
            level_boxes.append(self._decode(anchors, deltas))
            level_scores.append(scores)
            sizes.append(scores.shape[1])
        if self.cross_level_nms:
            # one (B, sum of sizes) problem: every level's candidates
            boxes = torch.cat(level_boxes, 1)
            scores = torch.cat(level_scores, 1)
            real = torch.ones_like(scores, dtype=torch.bool)
        else:
            # levels padded to one (B, L, m) batch with invalid slots
            m = max(sizes)
            boxes = torch.stack([F.pad(b, (0, 0, 0, m - b.shape[1])) for b in level_boxes], 1)
            scores = torch.stack([F.pad(s, (0, m - s.shape[1])) for s in level_scores], 1)
            real = torch.arange(m, device=boxes.device) < torch.tensor(
                sizes, device=boxes.device)[:, None]
        hbb = self._proposal_hbb(boxes)
        if self.min_bbox_size >= 0:
            w, h = self._proposal_wh(boxes, hbb)
            size_ok = (w > self.min_bbox_size) & (h > self.min_bbox_size)
        else:
            size_ok = torch.ones_like(real)
        size_ok = size_ok & real
        order, keep = nms(hbb, scores, self.nms_thresh, valid=size_ok)
        keep_pre = torch.zeros_like(keep).scatter(-1, order, keep)

        d = self.box_dim
        boxes, scores = boxes.reshape(B, -1, d), scores.reshape(B, -1)
        keep_pre, size_ok = keep_pre.reshape(B, -1), size_ok.reshape(B, -1)
        s = torch.where(size_ok, scores, float("-inf"))
        order = torch.sort(s, dim=-1, descending=True, stable=True).indices
        keep = torch.gather(keep_pre, 1, order)
        # kept slots first, each part in score order
        n_out = min(self.nms_post, sum(sizes))
        sel = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices[:, :n_out]
        idx = torch.gather(order, 1, sel)
        v = torch.gather(keep, 1, sel)
        out_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, d))
        return {"boxes": torch.where(v[..., None], out_boxes, 0.0),
                "scores": torch.where(v, torch.gather(scores, 1, idx), 0.0),
                "valid": v}


@HEADS.register_module()
class RPNHead(_RPNBase):
    """The classic hbb RPN: hbb deltas, hbb proposals (B, nms_post, 4)."""


@HEADS.register_module()
class GlidingRPNHead(_RPNBase):
    """Gliding Vertex's RPN: `RPNHead`'s hbb deltas and proposals, with one
    NMS per image over all levels (threshold 0.7 by default)."""

    cross_level_nms = True

    def __init__(self, *args, nms_thresh=0.7, **kw):
        super().__init__(*args, nms_thresh=nms_thresh, **kw)


@HEADS.register_module()
class OrientedRPNHead(_RPNBase):
    """The oriented RPN: midpoint offsets, rotated proposals (B,
    nms_post, 5)."""

    reg_dim = 6
    box_dim = 5

    def _encode(self, anchors, gts):
        return midpoint_offset_encode(anchors, gts, self.target_means, self.target_stds)

    def _decode(self, anchors, deltas):
        return midpoint_offset_decode(anchors, deltas, self.target_means, self.target_stds)

    def _gt_for_reg(self, targets):
        return targets["gt_bboxes"]

    def _proposal_hbb(self, boxes):
        return rbox_to_hbox(boxes)

    def _proposal_wh(self, boxes, hbb):
        return boxes[..., 2], boxes[..., 3]
