"""Vision models of the port."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2"]
