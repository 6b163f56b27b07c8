"""PD-FGC's motion-feature encoder: the FAN hourglass backbone and its four
heads (port of ``avi_talking_tpu/models/fan_encoder.py``, NCHW).

``FanBackbone`` (the reference's ``FAN_use``): a single-stack hourglass
landmark CNN, image -> 512-d feature. ``FanEncoder`` adds the heads:
headpose (6), eye (6), emotion (30) embeddings and the mouth feature (512).
``mask_lip`` blanks the mouth of the crops the emotion head conditions on.

* ``ConvBlock``: pre-activation BN-ReLU-conv x3 with the outputs
  concatenated (out = cat[c1(x), c2(c1), c3(c2)]), plus a BN-ReLU-1x1
  downsample residual where the width changes;
* ``HourGlass``: a depth-4 pool / upsample pyramid with skip adds, the
  upsample bilinear to the skip's size (``align_corners=False``; odd sizes
  floor on the way down, so 7 -> 3 -> 7 at 224^2);
* the head: 1x1 convs -> 68-channel heatmap -> BN / ReLU -> a strided 3x3 to
  one channel -> flatten -> Linear 512, whose input width is (size / 8)^2
  (784 at 224^2, the reference's).

Parameter names are the reference torch module's, so a reference FAN
state dict loads with ``load_state_dict(strict=True)``. BatchNorm runs on
its running statistics (the frozen towers run in eval mode).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..infra.device import resolve_device
from ..infra.init import random_module


class ConvBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        half, quarter = out_planes // 2, out_planes // 4
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = nn.Conv2d(in_planes, half, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(half)
        self.conv2 = nn.Conv2d(half, quarter, 3, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(quarter)
        self.conv3 = nn.Conv2d(quarter, quarter, 3, padding=1, bias=False)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(nn.BatchNorm2d(in_planes), nn.ReLU(),
                                            nn.Conv2d(in_planes, out_planes, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o1 = self.conv1(F.relu(self.bn1(x)))
        o2 = self.conv2(F.relu(self.bn2(o1)))
        o3 = self.conv3(F.relu(self.bn3(o2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([o1, o2, o3], dim=1) + res


class HourGlass(nn.Module):
    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for lvl in range(depth, 0, -1):
            for name in (f"b1_{lvl}", f"b2_{lvl}", f"b3_{lvl}"):
                self.add_module(name, ConvBlock(features, features))
        self.add_module("b2_plus_1", ConvBlock(features, features))

    def _level(self, x: torch.Tensor, lvl: int) -> torch.Tensor:
        up1 = getattr(self, f"b1_{lvl}")(x)
        low1 = getattr(self, f"b2_{lvl}")(F.max_pool2d(x, 2, 2))
        low2 = self._level(low1, lvl - 1) if lvl > 1 else self.b2_plus_1(low1)
        low3 = getattr(self, f"b3_{lvl}")(low2)
        return up1 + F.interpolate(low3, size=up1.shape[-2:], mode="bilinear",
                                   align_corners=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(x, self.depth)


def _fc_width(image_size: int) -> int:
    """The flattened width after conv1 (7x7 / 2, pad 3), the 2x2 pool and
    conv6 (3x3 / 2, pad 1): (size / 8)^2 for sizes that divide."""
    s = (image_size - 1) // 2 + 1
    s = s // 2
    s = (s - 1) // 2 + 1
    return s * s


class FanBackbone(nn.Module):
    """FAN_use: (B, 3, size, size) image -> (B, 512) feature."""

    def __init__(self, image_size: int = 224):
        super().__init__()
        self.image_size = image_size
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        self.m0 = HourGlass(4, 256)
        self.top_m_0 = ConvBlock(256, 256)
        self.conv_last0 = nn.Conv2d(256, 256, 1)
        self.bn_end0 = nn.BatchNorm2d(256)
        self.l0 = nn.Conv2d(256, 68, 1)
        self.bn5 = nn.BatchNorm2d(68)
        self.conv6 = nn.Conv2d(68, 1, 3, stride=2, padding=1)
        self.fc = nn.Linear(_fc_width(image_size), 512)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2:] != (self.image_size, self.image_size):
            # the hourglass's pyramid, and so fc's width, is built for one size;
            # below 64 px a level would bottom out at 0
            raise ValueError(f"FanBackbone built for {self.image_size}^2 crops, got "
                             f"{tuple(x.shape[-2:])}")
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.conv4(self.conv3(F.max_pool2d(self.conv2(x), 2, 2)))
        ll = self.bn_end0(self.conv_last0(self.top_m_0(self.m0(x))))
        net = self.conv6(F.relu(self.bn5(self.l0(F.relu(ll)))))
        return self.fc(F.relu(net.flatten(1)))  # one channel: CHW flattens as HW


def _head(embed_dim: int) -> Tuple[nn.Sequential, nn.Sequential]:
    """The reference's to_X (Linear-ReLU-BN1d-Linear) and X_embed (ReLU-Linear)."""
    return (nn.Sequential(nn.Linear(512, 512), nn.ReLU(), nn.BatchNorm1d(512), nn.Linear(512, 512)),
            nn.Sequential(nn.ReLU(), nn.Linear(512, embed_dim)))


class FanEncoder(nn.Module):
    """(B, 3, size, size) -> headpose (6), eye (6), emo (30) embeddings and
    the mouth feature (512)."""

    def __init__(self, image_size: int = 224, pose_dim: int = 6, eye_dim: int = 6,
                 emo_dim: int = 30):
        super().__init__()
        self.model = FanBackbone(image_size)
        self.to_mouth, self.mouth_embed = _head(512 - pose_dim - eye_dim)
        self.to_headpose, self.headpose_embed = _head(pose_dim)
        self.to_eye, self.eye_embed = _head(eye_dim)
        self.to_emo, self.emo_embed = _head(emo_dim)

    @classmethod
    def random_init(cls, image_size: int = 224, seed: int = 0, device=None) -> "FanEncoder":
        """Seeded random weights (``infra.init``), in eval mode; ``device=None``
        means CUDA."""
        return random_module(lambda: cls(image_size), resolve_device(device),
                             torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor):
        feat = self.model(x)
        mouth_feat = self.to_mouth(feat)
        return (self.headpose_embed(self.to_headpose(feat)), self.eye_embed(self.to_eye(feat)),
                self.emo_embed(self.to_emo(feat)), mouth_feat)

    def backbone_feature(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def mask_lip(images: torch.Tensor, variant: str = "coeff") -> torch.Tensor:
    """Zero the lip region of (B, 3, H, W) crops in [-1, 1]: "coeff" is the
    reference's ``faceformer.py:114-126`` box, "disentangle" the wider
    ``faceformer_disentangle.py:119-133`` one (the lower half of the face).
    The box's edges truncate as Python's ``int()`` does, as in JAX."""
    H, W = images.shape[-2:]
    if variant == "coeff":
        h0, h1 = int(100 / 224 * H), int(210 / 224 * H)
        w0, w1 = int(40 / 224 * W), int(185 / 224 * W)
    else:
        h0, h1 = int(100 / 224 * H), H
        w0, w1 = 0, W
    mask = torch.ones(H, W, dtype=images.dtype, device=images.device)
    mask[h0:h1, w0:w1] = 0.0
    return images * mask
