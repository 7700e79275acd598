"""Detection losses."""
from .basic import (
    binary_cross_entropy_loss,
    cross_entropy_loss,
    sigmoid_focal_loss,
    smooth_l1_loss,
    weight_reduce_loss,
)
