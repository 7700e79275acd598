"""CSL rotated RetinaNet head: the angle as a classification.

Port of `jdet_tpu/models/heads/csl_retina_head.py::CSLRRetinaHead` (:31;
the angle branch :55-66, `loss` :67, `predict` :126). A 1x1 conv off the
regression tower classifies each anchor's encoded delta angle into
`coding_len` = 180 / omega circular bins (9 anchors x 45 bins = 405
channels at omega 4); its targets are the CSL coder's smooth labels of
the positives' delta angles, trained with the smooth focal loss; at test
time the decoded angle replaces the regressed delta angle before the
boxes are decoded.
"""
from __future__ import annotations

import torch

from ...utils.registry import HEADS
from ..boxes.coder import CSLCoder
from ..layers import Conv2d, bias_init_with_prob, normal_init
from ..losses import smooth_focal_loss
from .rotated_retina_head import RotatedRetinaHead


@HEADS.register_module()
class CSLRRetinaHead(RotatedRetinaHead):
    def __init__(self, *args, angle_coder=dict(omega=4, window="gaussian", radius=3),
                 loss_angle=dict(gamma=2.0, alpha=0.25, loss_weight=0.8), generator=None,
                 **kw):
        super().__init__(*args, generator=generator, **kw)
        if self.loss_bbox_cfg.get("type", "smooth_l1") != "smooth_l1":
            raise ValueError("the CSL head regresses its deltas with smooth-L1")
        self.angle_coder = CSLCoder(**angle_coder)
        self.coding_len = self.angle_coder.coding_len
        self.loss_angle_cfg = dict(loss_angle)
        self.retina_angle_cls = Conv2d(
            self.feat_channels, self.num_anchors * self.coding_len, 1,
            kernel_init=normal_init(0.01), bias_value=bias_init_with_prob(0.01),
            generator=generator,
        )

    def forward_single(self, x):
        reg_feat = x
        for conv in self.reg_convs:
            reg_feat = conv(reg_feat)
        cls_feat = x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        return (self.retina_cls(cls_feat), self.retina_reg(reg_feat),
                self.retina_angle_cls(reg_feat))

    def loss(self, outs, targets):
        losses, outs, tgt, num_total = self._losses_and_targets(outs, targets)
        b = outs[0][0].shape[0]
        angle_preds = torch.cat([self._nhwc(o[2], b, self.coding_len) for o in outs], 1)
        # smooth labels of the positives' encoded delta angles
        acfg = self.loss_angle_cfg
        losses["loss_angle"] = smooth_focal_loss(
            angle_preds, self.angle_coder.encode(tgt["bbox_targets"][..., 4]),
            weight=tgt["bbox_weights"][..., 4], gamma=acfg.get("gamma", 2.0),
            alpha=acfg.get("alpha", 0.25), avg_factor=num_total,
        ) * acfg.get("loss_weight", 0.8)
        return losses

    def _predict_deltas(self, out, b):
        """The regressed deltas with the delta angle decoded from the
        angle logits."""
        angle = self.angle_coder.decode(torch.sigmoid(self._nhwc(out[2].float(), b,
                                                                 self.coding_len)))
        return torch.cat([self._reg_to_deltas(out[1].float(), b)[..., :4], angle[..., None]], -1)
