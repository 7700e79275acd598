"""Detection heads."""
from .csl_retina_head import CSLRRetinaHead
from .fcos_head import FCOSHead
from .h2rbox_head import H2RBoxHead
from .ld_retina_head import LDRotatedRetinaHead, RotatedRetinaDistributionHead
from .obb_roi_heads import ReDetHead, RoITransHead, StripHead
from .oriented_head import OrientedHead
from .r3det_head import R3DetHead
from .reppoints_head import RotatedRepPointsHead
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
from .ssd_head import SSDHead
