"""H2RBox: oriented detection learnt from horizontal boxes.

Port of `jdet_tpu/models/detectors/h2rbox.py` (`rotate_image`,
`rotate_rboxes`, `H2RBox`). The image passes twice: as it is, and rotated
by a random theta about its centre (a bilinear sample, zeros outside),
each through the whole backbone and neck. The head is supervised on the
first view by the gts' circumscribed horizontal boxes only; a
self-supervised term ties the rotated view's predictions to the first
view's rotated by theta, which teaches the angle.

Theta is drawn uniform in [0.25 pi, 0.75 pi) (`rot_range`, in units of
pi) from the train step's `torch.Generator` (a generator seeded with 0
without one); `loss(..., theta=)` takes it from the caller instead, as a
test replaying the reference's draw does.
"""
from __future__ import annotations

import math

import torch

from ...ops.box_convert import hbox_to_rbox, norm_angle, rbox_to_hbox
from ...ops.deform_conv import bilinear_sample
from ...utils.registry import MODELS
from ..layers import sigmoid
from .single_stage import SingleStageDetector


def _rotation_grid(h, w, theta, dtype, device):
    """The source pixel (sy, sx), each (h, w), of every pixel of the view
    rotated by theta about the centre: R(-theta) (p - c) + c. A float64
    grid takes the cosine and sine of theta in float64."""
    theta = theta.to(torch.promote_types(dtype, theta.dtype))
    yy, xx = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    sx = cos * (xx - cx) + sin * (yy - cy) + cx
    sy = -sin * (xx - cx) + cos * (yy - cy) + cy
    return sy, sx


def rotate_image(images, theta):
    """(B, H, W, C) images rotated by theta about their centre (bilinear,
    zeros outside)."""
    B, H, W, _ = images.shape
    sy, sx = _rotation_grid(H, W, theta, images.dtype, images.device)
    out = bilinear_sample(images.permute(0, 3, 1, 2), sy.expand(B, H, W), sx.expand(B, H, W))
    return out.permute(0, 2, 3, 1)


def rotate_rboxes(rboxes, theta, w, h):
    """(..., 5) rboxes rotated by theta about the centre of a w x h
    image."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    ox, oy = rboxes[..., 0] - cx, rboxes[..., 1] - cy
    return torch.stack([cos * ox - sin * oy + cx, sin * ox + cos * oy + cy,
                        rboxes[..., 2], rboxes[..., 3], norm_angle(rboxes[..., 4] + theta)], -1)


@MODELS.register_module()
class H2RBox(SingleStageDetector):
    def __init__(self, backbone, neck=None, bbox_head=None, ss_loss_weight=0.4,
                 rot_range=(0.25, 0.75)):
        super().__init__(backbone, neck, bbox_head)
        self.ss_loss_weight = ss_loss_weight
        self.rot_range = rot_range  # in units of pi

    def draw_theta(self, generator, device):
        lo, hi = (r * math.pi for r in self.rot_range)
        u = torch.rand((), generator=generator, device=device)
        return lo + (hi - lo) * u

    def loss(self, images, targets, generator=None, theta=None):
        """Training forward on images (B, H, W, 3) and gt_bboxes /
        gt_labels / gt_mask. `theta` (a float32 scalar tensor) overrides
        the draw from `generator`."""
        if theta is None:
            if generator is None:
                generator = torch.Generator(device=images.device).manual_seed(0)
            theta = self.draw_theta(generator, images.device)
        theta = torch.as_tensor(theta, dtype=torch.float32, device=images.device)
        weak = dict(targets)
        weak["gt_bboxes"] = hbox_to_rbox(rbox_to_hbox(targets["gt_bboxes"].float()))
        head = self.bbox_head
        outs1 = head(self.extract_feat(images))
        feats2 = self.extract_feat(rotate_image(images, theta))
        if hasattr(head, "loss_with_aug"):
            # H2RBoxHead: the rotated view through the regression tower only
            return head.loss_with_aug(outs1, head.forward_aug(feats2), theta, weak)

        # another head (FCOS's): its own losses, and the consistency of the
        # dense angle maps, view 2's angle against view 1's + theta at the
        # location that rotates onto it, weighted by view 1's centerness
        losses = head.loss(outs1, weak)
        outs2 = head(feats2)
        ss = 0.0
        for (_, _, t1, ct1), (_, _, t2, _) in zip(outs1, outs2):
            b, _, h, w = t1.shape
            sy, sx = _rotation_grid(h, w, theta, t1.dtype, t1.device)
            sy, sx = sy.expand(b, h, w), sx.expand(b, h, w)
            t1r = bilinear_sample(t1, sy, sx)
            w1 = sigmoid(bilinear_sample(ct1, sy, sx)).detach()
            d = t2 - (t1r + theta)
            d = (d + math.pi / 2) % math.pi - math.pi / 2
            ss = ss + (d.abs() * w1).sum() / w1.sum().clamp(min=1.0)
        losses["loss_ss"] = ss * self.ss_loss_weight
        return losses
