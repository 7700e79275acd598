"""Detection losses."""
from .basic import sigmoid_focal_loss, smooth_l1_loss, weight_reduce_loss
