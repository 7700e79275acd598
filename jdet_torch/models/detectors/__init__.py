"""Detectors."""
from .single_stage import RotatedRetinaNet, S2ANet, SingleStageDetector
from .two_stage import RCNN, OrientedRCNN, ReDet, RoITransformer
