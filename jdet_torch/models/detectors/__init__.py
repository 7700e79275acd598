"""Detectors."""
from .single_stage import RotatedRetinaNet, S2ANet, SingleStageDetector
