"""Box ops: codecs, rotated IoU (with its CUDA kernel), rotated and
horizontal NMS, and the rotated RoI align."""
from .box_convert import (
    delta2hbox,
    delta2rbox,
    distance2obb,
    hbox2delta,
    hbox_to_rbox,
    mintheta_obb,
    norm_angle,
    poly_to_hbox,
    poly_to_rbox,
    rbox2delta,
    rbox_to_hbox,
    rbox_to_poly,
    regular_obb,
    regular_theta,
)
from .box_iou_rotated import box_iou_rotated, box_iou_rotated_aligned
from .nms_rotated import multiclass_nms_rotated, nms_rotated
from .rotated_iou_kernel import (
    FAR_CENTER,
    box_iou_rotated_generic,
    box_iou_rotated_generic_reference,
    box_iou_rotated_rect,
    box_iou_rotated_rect_reference,
    park_masked_boxes,
)
