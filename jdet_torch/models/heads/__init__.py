"""Detection heads."""
from .rotated_retina_head import RotatedRetinaHead
from .s2anet_head import S2ANetHead
