"""Backbones."""
from .lsknet import LSKNet, StripNet
from .re_resnet import ReResNet
from .res2net import Res2Net
from .resnet import ResNet, ResNet_v1d, load_torch_resnet
from .ssd_vgg import SSDNeck, SSDVGG
