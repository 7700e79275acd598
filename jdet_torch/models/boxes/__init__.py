"""Anchors, assignment, sampling and targets."""
from .anchor_generator import (
    AnchorGeneratorHBB,
    AnchorGeneratorRotated,
    AnchorGeneratorRotatedS2ANet,
)
from .anchor_target import anchor_target_batch, anchor_target_single
from .assigner import assign_wrt_overlaps, max_iou_assign_rotated
from .sampler import pseudo_sample
