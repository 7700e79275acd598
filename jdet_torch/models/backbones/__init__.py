"""Backbones."""
from .lsknet import LSKNet, StripNet
from .re_resnet import ReResNet
from .resnet import ResNet, ResNet_v1d
from .ssd_vgg import SSDNeck, SSDVGG
