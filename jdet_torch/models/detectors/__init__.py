"""Detectors."""
from .single_stage import (KnowledgeDistillationSingleStageDetector, RotatedRetinaNet, S2ANet,
                           SingleStageDetector)
from .two_stage import RCNN, OrientedRCNN, ReDet, RoITransformer
