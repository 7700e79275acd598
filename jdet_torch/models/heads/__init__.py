"""Detection heads."""
from .rotated_retina_head import RotatedRetinaHead
