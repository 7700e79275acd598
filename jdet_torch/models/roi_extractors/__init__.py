"""RoI feature extractors."""
from .single_level import OrientedSingleRoIExtractor, SingleRoIExtractor
