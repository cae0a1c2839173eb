"""The ResNet family (counterpart of paddle_tpu/vision/models/resnet.py:
resnet18/34/50/101/152 and the wide ResNets), NCHW, with the reference's
layer names, so that a reference state dict (parameters and the batch
norms' `_mean` / `_variance`) loads one to one (models/convert.py).

Weights are drawn on the CPU from a torch.Generator (`generator`, else
one seeded with `seed`, by default the last paddle.seed's), then the
model moves to `device` (default the current place, the card unless
set_device("cpu"); raises without CUDA).

    from paddle_tpu_torch.vision.models import resnet50
    net = resnet50(num_classes=100)              # on the card
"""
from __future__ import annotations

import torch

from ... import nn
from ...framework.device import resolve_device
from ...framework.random import init_seed
from ...tensor import flatten

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2"]

LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
          101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, generator=generator)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               generator=generator)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(torch.nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               generator=generator)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False,
                               generator=generator)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, generator=generator)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(torch.nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, generator=None):
        super().__init__()
        layers = LAYERS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, generator=generator)
        self.bn1 = nn.BatchNorm2D(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, generator)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, generator)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, generator)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, generator)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                generator=generator)

    def _make_layer(self, block, planes, blocks, stride=1, generator=None):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False,
                          generator=generator),
                nn.BatchNorm2D(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, generator=generator)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                generator=generator))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x


def _make(block, depth, pretrained=False, seed=None, device=None,
          generator=None, **kwargs):
    """The model on `device` (resolved first, so that a missing CUDA raises
    before any work), weights drawn from `generator` or a generator seeded
    with `seed`; each parameter's `qualname` is its qualified name, which
    the optimizer hands to apply_decay_param_fun. No pretrained weights:
    the port downloads nothing."""
    if pretrained:
        raise ValueError("pretrained weights are not available: the port "
                         "downloads nothing (models/convert.py loads a "
                         "reference state dict)")
    dev = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(init_seed(seed))
    model = ResNet(block, depth, generator=gen, **kwargs).to(dev)
    for pname, p in model.named_parameters():
        p.qualname = pname
    return model


def resnet18(pretrained=False, **kwargs):
    return _make(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _make(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _make(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _make(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _make(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _make(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _make(BottleneckBlock, 101, pretrained, width=128, **kwargs)
