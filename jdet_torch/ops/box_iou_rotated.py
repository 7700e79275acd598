"""Rotated-box IoU — exact, sort-free, differentiable (Green's theorem).

Port of `jdet_tpu/ops/box_iou_rotated.py` (`_corners_xy` :34,
`_edges_green_contrib` :60 as `rotated_iou_kernel.edges_green_sum`,
`_intersection_area` :112 as `rotated_intersection_area`, `box_iou_rotated_aligned` :147,
`box_iou_rotated` :162).

The boundary of P∩Q is (∂P clipped to Q) ∪ (∂Q clipped to P); by Green's
theorem area = 1/2 Σ cross(u, v) over the directed boundary segments in
any order. Each rectangle edge's surviving sub-segment against the other
rectangle's four half-planes comes from Liang–Barsky interval clipping —
closed form, elementwise over the pair-shaped tensors.

Large `iou` matrices on a CUDA tensor go to the hand-written kernel
(`rotated_iou_kernel.box_iou_rotated_rect`), forward only, as the
reference sends them to its Pallas kernel.
"""
from __future__ import annotations

import torch

from .rotated_iou_kernel import box_iou_rotated_rect, edges_green_sum

# pair count from which an `iou` matrix on the card goes to the kernel
# (the reference's auto-dispatch bar, box_iou_rotated.py:184)
KERNEL_MIN_PAIRS = 1 << 20


def _corners_xy(boxes):
    """(..., 5) rbox -> four corner x tensors and y tensors, positively
    oriented for the cross convention below."""
    cx, cy, w, h, a = boxes.unbind(-1)
    cos2 = torch.cos(a) * 0.5
    sin2 = torch.sin(a) * 0.5
    x0 = cx - sin2 * h - cos2 * w
    y0 = cy + cos2 * h - sin2 * w
    x1 = cx + sin2 * h - cos2 * w
    y1 = cy - cos2 * h - sin2 * w
    x2 = 2 * cx - x0
    y2 = 2 * cy - y0
    x3 = 2 * cx - x1
    y3 = 2 * cy - y1
    return [x0, x1, x2, x3], [y0, y1, y2, y3]


def rotated_intersection_area(b1, b2):
    """Exact intersection area for broadcast-compatible (..., 5) boxes."""
    # Recenter near the pair midpoint: Green contributions are ~|p|^2, so
    # absolute image coordinates (~1e3) would lose fp32 precision.
    mx = 0.5 * (b1[..., 0] + b2[..., 0])
    my = 0.5 * (b1[..., 1] + b2[..., 1])

    c1x, c1y = _corners_xy(b1)
    c2x, c2y = _corners_xy(b2)
    c1x = [x - mx for x in c1x]
    c1y = [y - my for y in c1y]
    c2x = [x - mx for x in c2x]
    c2y = [y - my for y in c2y]

    s = edges_green_sum(c1x, c1y, c2x, c2y) + edges_green_sum(c2x, c2y, c1x, c1y)
    return (0.5 * s).clamp(min=0.0)


def _iou_from_areas(inter, area1, area2, mode="iou"):
    if mode == "iou":
        union = area1 + area2 - inter
    elif mode == "iof":
        union = area1.expand_as(inter)
    else:
        raise ValueError(mode)
    return torch.where(union > 1e-9, inter / union.clamp(min=1e-9), 0.0)


def box_iou_rotated_aligned(boxes1, boxes2, mode="iou"):
    """Elementwise IoU of two equal-shaped (..., 5) box tensors."""
    inter = rotated_intersection_area(boxes1, boxes2)
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    return _iou_from_areas(inter, a1, a2, mode)


def _pairwise_block(boxes1, boxes2, mode):
    inter = rotated_intersection_area(boxes1.unsqueeze(-2), boxes2.unsqueeze(-3))
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    return _iou_from_areas(inter, a1[..., :, None], a2[..., None, :], mode)


def box_iou_rotated(boxes1, boxes2, mode="iou", chunk=4096, impl="auto"):
    """Pairwise IoU matrix (..., n, m) of rotated boxes (..., n, 5) against
    (..., m, 5); leading dimensions broadcast (the reference's vmap,
    written out).

    impl="auto" sends an `iou` matrix of n·m >= 2^20 pairs on a CUDA
    tensor to the rect-frame kernel, without gradient (the reference's
    stop_gradient); impl="cuda" always takes the kernel's wrapper, and
    impl="xla" always this differentiable path, row-chunked by `chunk`.
    """
    n = boxes1.shape[-2]
    m = boxes2.shape[-2]
    if n == 0 or m == 0:
        batch = torch.broadcast_shapes(boxes1.shape[:-2], boxes2.shape[:-2])
        return boxes1.new_zeros((*batch, n, m))
    if impl == "cuda" or (
        impl == "auto"
        and mode == "iou"
        and n * m >= KERNEL_MIN_PAIRS
        and boxes1.is_cuda
    ):
        with torch.no_grad():
            return box_iou_rotated_rect(
                boxes1.float().contiguous(), boxes2.float().contiguous()
            )
    if n <= chunk:
        return _pairwise_block(boxes1, boxes2, mode)
    return torch.cat(
        [
            _pairwise_block(boxes1[..., i:i + chunk, :], boxes2, mode)
            for i in range(0, n, chunk)
        ],
        dim=-2,
    )
