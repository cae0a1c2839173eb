"""LeNet (counterpart of paddle_tpu/vision/models/lenet.py): two
convolutions with ReLU and 2x2 max pooling, then three Linear layers, for
1x28x28 inputs."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...framework.random import init_seed
from ...nn import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ...tensor import flatten

__all__ = ["LeNet"]


class LeNet(nn.Module):
    """The reference's LeNet, on `device` (default the current place: the
    card unless set_device("cpu"); raises without CUDA), its weights drawn
    from `generator` or a generator seeded with `seed` (default: the last
    paddle.seed's). The parameter names are the reference's
    (`features.0.weight`, ..., `fc.2.bias`); each parameter's `qualname`
    is its name."""

    def __init__(self, num_classes=10, device=None, seed=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None \
            else torch.Generator().manual_seed(init_seed(seed))
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, generator=g),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, generator=g),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, generator=g),
                Linear(120, 84, generator=g),
                Linear(84, num_classes, generator=g),
            )
        self.to(dev)
        for pname, p in self.named_parameters():
            p.qualname = pname

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x
