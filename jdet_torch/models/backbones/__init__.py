"""Backbones."""
from .resnet import ResNet
