"""Backbones."""
from .re_resnet import ReResNet
from .resnet import ResNet, ResNet_v1d
