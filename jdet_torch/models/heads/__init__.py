"""Detection heads."""
from .obb_roi_heads import ReDetHead, RoITransHead
from .oriented_head import OrientedHead
from .rotated_retina_head import RotatedRetinaHead
from .rpn_heads import OrientedRPNHead, RPNHead
from .s2anet_head import S2ANetHead
