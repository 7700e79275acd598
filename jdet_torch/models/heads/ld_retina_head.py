"""Distribution rotated RetinaNet head and localization distillation.

Port of `jdet_tpu/models/heads/ld_retina_head.py`:
`RotatedRetinaDistributionHead` (:27) regresses each of the 5 deltas as a
distribution over reg_max + 1 bins (a `retina_reg` of A * 5 * (reg_max + 1)
channels), reduced to its expectation (`ops/box_convert.py::integral`,
`integral_angle`) before the regression loss and the decode;
`LDRotatedRetinaHead` (:78) adds the KD term: the KL divergence, at
temperature T, of every anchor's student distributions from a teacher's,
which take no gradient.
"""
from __future__ import annotations

import torch

from ...ops.box_convert import integral, integral_angle
from ...utils.registry import HEADS
from ..layers import Conv2d, normal_init
from ..losses import knowledge_distillation_kl_div_loss
from .rotated_retina_head import RotatedRetinaHead


@HEADS.register_module()
class RotatedRetinaDistributionHead(RotatedRetinaHead):
    def __init__(self, *a, reg_max=8, generator=None, **kw):
        super().__init__(*a, generator=generator, **kw)
        self.reg_max = reg_max
        # the 5-channel regressor replaced by 5 * (reg_max + 1) bins
        self.retina_reg = Conv2d(self.feat_channels, self.num_anchors * 5 * (reg_max + 1), 1,
                                 kernel_init=normal_init(0.01), generator=generator)

    def _integrate(self, reg_flat):
        """(rows, 5 * (reg_max + 1)) distributions -> (rows, 5) expected
        deltas."""
        n = self.reg_max
        d = reg_flat.reshape(-1, 5, n + 1)
        xy_wh = integral(d[:, :4].reshape(-1, n + 1), n).reshape(-1, 4)
        return torch.cat([xy_wh, integral_angle(d[:, 4], n).reshape(-1, 1)], -1)

    def _reg_to_deltas(self, reg, b):
        flat = self._nhwc(reg, b, 5 * (self.reg_max + 1))
        return self._integrate(flat.reshape(-1, flat.shape[-1])).reshape(b, -1, 5)

    def _flatten_dist(self, outs):
        """The raw (B, A_total, 5 * (reg_max + 1)) distributions of every
        level, in the outputs' dtype."""
        b = outs[0][1].shape[0]
        return torch.cat([self._nhwc(o[1], b, 5 * (self.reg_max + 1)) for o in outs], 1)


@HEADS.register_module()
class LDRotatedRetinaHead(RotatedRetinaDistributionHead):
    def __init__(self, *a, loss_ld=dict(T=10.0, loss_weight=0.25), **kw):
        super().__init__(*a, **kw)
        self.loss_ld_cfg = dict(loss_ld)

    def loss_with_teacher(self, outs, teacher_outs, targets):
        """`loss` plus `loss_ld`, the KD term over every anchor's
        distributions, in the student outputs' dtype, averaged over the
        rows."""
        losses = self.loss(outs, targets)
        s = self._flatten_dist(outs)
        t = self._flatten_dist(teacher_outs).detach()
        n1 = self.reg_max + 1
        kd = knowledge_distillation_kl_div_loss(s.reshape(-1, n1), t.reshape(-1, n1).to(s.dtype),
                                                T=self.loss_ld_cfg.get("T", 10.0))
        losses["loss_ld"] = kd * self.loss_ld_cfg.get("loss_weight", 0.25)
        return losses
