"""Two-stage detectors: backbone -> neck -> RPN -> RoI head.

Port of `jdet_tpu/models/detectors/two_stage.py` (`RCNN` :20,
`OrientedRCNN` :67, `FasterRCNNOBB` :73, `GlidingVertex` :78,
`RoITransformer` :83, `StripRCNN` :88, `ReDet` :93). Images come in as
(B, H, W, 3) NHWC float32 and are permuted to NCHW once. `loss` adds the
RPN's losses to the RoI head's, the RoI head working on the RPN's
proposals without their gradient.

Randomness: both samplers (the RPN's anchors, the RoI head's proposals)
draw uniforms from `generator` (a `torch.Generator` on the images'
device; the train step seeds one per iteration, and without one the loss
seeds its own with 0, as the reference takes `PRNGKey(0)`), or from
`rand(shape)`, which a caller replaying another stream of draws passes;
the draws come in the order RPN positives, RPN negatives, then the RoI
head's (positives, negatives; for the cascades of RoI-Transformer and
ReDet, stage 1's, then stage 2's).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.box_convert import rbox_to_hbox
from ...utils.registry import MODELS


@MODELS.register_module()
class RCNN(nn.Module):
    def __init__(self, backbone, neck=None, rpn_head=None, bbox_head=None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.bbox_head = bbox_head

    def extract_feat(self, images):
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        if self.neck is not None:
            feats = self.neck(feats)
        return feats

    def loss(self, images, targets, generator=None, rand=None):
        """Training forward: images (B, H, W, 3), targets dict with
        gt_bboxes / gt_labels / gt_mask (and gt_hboxes, else computed).
        Returns the dict of the scalar losses."""
        if rand is None and generator is None:
            generator = torch.Generator(device=images.device).manual_seed(0)
        targets = dict(targets)
        if "gt_hboxes" not in targets:
            targets["gt_hboxes"] = rbox_to_hbox(targets["gt_bboxes"].float())
        feats = self.extract_feat(images)
        rpn_outs = self.rpn_head(feats)
        losses = self.rpn_head.loss(rpn_outs, targets, rand=rand, generator=generator)
        proposals = self.rpn_head.get_proposals(rpn_outs)
        losses.update(self.bbox_head.loss(feats, proposals, targets, rand=rand,
                                          generator=generator))
        return losses

    @torch.no_grad()
    def predict(self, images, targets=None):
        feats = self.extract_feat(images)
        proposals = self.rpn_head.get_proposals(self.rpn_head(feats))
        return self.bbox_head.predict(feats, proposals, targets)


@MODELS.register_module()
class OrientedRCNN(RCNN):
    """RCNN with `OrientedRPNHead` and `OrientedHead`."""


@MODELS.register_module()
class FasterRCNNOBB(RCNN):
    """RCNN with `RPNHead` and `FasterrcnnHead` (hbb proposals, rotated
    boxes out)."""


@MODELS.register_module()
class GlidingVertex(RCNN):
    """RCNN with `GlidingRPNHead` and `GlidingHead`."""


@MODELS.register_module()
class RoITransformer(RCNN):
    """RCNN with `RPNHead` and the `RoITransHead` cascade."""


@MODELS.register_module()
class ReDet(RCNN):
    """RCNN on `ReResNet` and `ReFPN` with `RPNHead` and `ReDetHead`."""


@MODELS.register_module()
class StripRCNN(RCNN):
    """RCNN on `StripNet` with an RPN and `StripHead`. The head works on
    rotated proposals: the reference's committed
    `configs/strip_rcnn_stripnet_s_fpn_1x_dota.py` gives it the hbb
    `RPNHead`, whose (B, N, 4) proposals its loss cannot prepend the
    (B, K, 5) gts to (the reference fails there with a TypeError,
    `jdet_tpu/models/heads/oriented_head.py:121`); this refuses that
    composition when it is built. With `OrientedRPNHead` it runs, in
    both packages."""

    def __init__(self, backbone, neck=None, rpn_head=None, bbox_head=None):
        if rpn_head is not None and rpn_head.box_dim != 5:
            raise ValueError(
                f"StripRCNN: {type(rpn_head).__name__} proposes {rpn_head.box_dim}-d boxes "
                f"but {type(bbox_head).__name__} takes rotated (5-d) proposals; the "
                "reference fails on this composition at jdet_tpu/models/heads/"
                "oriented_head.py:121 (concatenating the (B, K, 5) gts with (B, N, 4) "
                "proposals). Use rpn_head=dict(type='OrientedRPNHead', ...).")
        super().__init__(backbone, neck, rpn_head, bbox_head)
