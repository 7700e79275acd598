"""C8 group convolutions (ReDet's equivariant bricks)."""
from .econv import (
    N_ORIENT,
    InnerBatchNorm,
    REConv2d,
    REConv2dLift,
    cache_expanded_weights,
    cache_frozen_expansions,
    rotation_interp_matrix,
)
