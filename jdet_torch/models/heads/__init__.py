"""Detection heads."""
from .csl_retina_head import CSLRRetinaHead
from .ld_retina_head import LDRotatedRetinaHead, RotatedRetinaDistributionHead
from .obb_roi_heads import ReDetHead, RoITransHead
from .oriented_head import OrientedHead
from .rotated_retina_head import (
    GWDRetinaHead,
    KFIoURRetinaHead,
    KLDRetinaHead,
    RotatedATSSHead,
    RotatedRetinaHead,
    RSDetHead,
)
from .rpn_heads import OrientedRPNHead, RPNHead
from .s2anet_head import S2ANetHead
