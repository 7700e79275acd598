"""Necks."""
from .fpn import FPN
