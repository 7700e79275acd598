"""Detection heads."""
from .oriented_head import OrientedHead
from .rotated_retina_head import RotatedRetinaHead
from .rpn_heads import OrientedRPNHead
from .s2anet_head import S2ANetHead
