"""ResNet-50 backbone, eval mode, NCHW (port of ``avi_talking_tpu/models/resnet.py``).

The vision tower of the EMOCA / EmoNet family. Parameter names are
torchvision's ``resnet50`` (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0`` / ``.1``, ...), so a torchvision state dict
without ``fc`` loads as it is. The stride sits on each first block's 3x3
conv (torchvision's v1.5 layout, as the JAX module); BatchNorm (eps 1e-5)
reads its running statistics (``ops.layers.BatchNorm2d``); the output is
the global average pool.

``dtype`` is the compute dtype (``ops.layers``, the JAX modules' ``dtype``):
under bfloat16 the convolutions run on bfloat16 inputs and weights, each
BatchNorm normalises in float32 and rounds to bfloat16, and the pool
returns bfloat16.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.layers import BatchNorm2d, Conv2d, set_compute_dtype

_LAYERS50 = (3, 4, 6, 3)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, with a projected shortcut on the
    first block of a stage."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=1e-5)
        self.downsample = (nn.Sequential(Conv2d(in_planes, planes * 4, 1, stride=stride,
                                                bias=False),
                                         BatchNorm2d(planes * 4, eps=1e-5))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(out + shortcut)


class ResNet50(nn.Module):
    """(B, 3, H, W) -> (B, 2048) pooled feature; BatchNorm normalises by
    the running statistics in every mode, as the JAX module does."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)  # JAX: pad with -inf, then 3 / 2
        in_planes, planes = 64, 64
        for li, blocks in enumerate(_LAYERS50):
            layer = []
            for bi in range(blocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                layer.append(Bottleneck(in_planes, planes, stride, downsample=bi == 0))
                in_planes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
            planes *= 2
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for li in range(len(_LAYERS50)):
            x = getattr(self, f"layer{li + 1}")(x)
        return x.mean(dim=(2, 3))
