"""Necks."""
from .fpn import FPN
from .re_fpn import ReFPN
