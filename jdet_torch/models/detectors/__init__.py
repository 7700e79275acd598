"""Detectors."""
from .h2rbox import H2RBox
from .single_stage import (FCOS, KnowledgeDistillationSingleStageDetector, R3Det,
                           RotatedRepPoints, RotatedRetinaNet, S2ANet, SingleStageDetector)
from .two_stage import RCNN, OrientedRCNN, ReDet, RoITransformer, StripRCNN
from .yolo import YOLO
