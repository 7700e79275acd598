"""Detectors."""
from .single_stage import RotatedRetinaNet, SingleStageDetector
