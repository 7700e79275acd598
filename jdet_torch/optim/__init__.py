"""Optimizer and learning-rate schedule of the train step."""
from .lr_scheduler import build_group_lr_schedules, build_lr_schedule
from .optimizer import Optimizer, build_optimizer
