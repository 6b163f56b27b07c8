"""Lip-reading feature network and its consistency loss (port of
``avi_talking_tpu/models/lipread.py``).

Grayscale mouth crops -> the visual front end of the "Lipreading using
Temporal Convolutional Networks" model (a Conv3d(1 -> 64, k (5, 7, 7),
s (1, 2, 2), p (2, 3, 3)) + BatchNorm + swish + MaxPool3d (1, 3, 3) /
(1, 2, 2) / (0, 1, 1), then a ResNet-18 trunk of BasicBlocks [2, 2, 2, 2]
at 64 / 128 / 256 / 512 with swish and a global average pool) ->
per-frame 512-d features, taken before the TCN head as the reference's
loss takes them. The loss is a cosine (or L1 / MSE) distance between the
predicted and the ground-truth renders' features, the ground truth
detached. Parameter names follow the reference's ``frontend3D`` /
``trunk.layer{1..4}.{0,1}`` so a VSR state dict loads as it is. BatchNorm
reads its running statistics in every mode. ``dtype`` is the compute dtype
(``ops.layers``), as JAX's: the Conv3d front end, the trunk and the pool
run at it, the swish as ``x * sigmoid(x)`` rounded op by op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.layers import BatchNorm2d, BatchNorm3d, Conv2d, Conv3d, set_compute_dtype, silu

LIPREAD_MEAN = 0.421
LIPREAD_STD = 0.165


def _act(name: str):
    if name == "swish":
        return silu
    if name == "relu":
        return F.relu
    if name == "prelu":  # the loss nets use a fixed slope of 0.25
        return lambda x: torch.where(x >= 0, x, 0.25 * x)
    raise ValueError(name)


class BasicBlock(nn.Module):
    """ResNet BasicBlock: two 3x3 convs, a projected shortcut where the
    width or the stride changes."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, relu_type: str = "swish"):
        super().__init__()
        self.relu_type = relu_type
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (nn.Sequential(Conv2d(in_planes, planes, 1, stride=stride,
                                                bias=False), BatchNorm2d(planes))
                           if in_planes != planes or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = _act(self.relu_type)
        h = act(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return act(h + (x if self.downsample is None else self.downsample(x)))


class _Trunk(nn.Module):
    def __init__(self, relu_type: str):
        super().__init__()
        in_planes = 64
        for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            setattr(self, f"layer{li + 1}", nn.Sequential(
                BasicBlock(in_planes, planes, stride, relu_type),
                BasicBlock(planes, planes, 1, relu_type)))
            in_planes = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
        return x.mean(dim=(2, 3))


class LipReadingNet(nn.Module):
    """(B, T, H, W, 1) mouth crops, already ``mouth_transform``-ed (the JAX
    layout) -> (B, T, 512) per-frame visual-speech features."""

    def __init__(self, relu_type: str = "swish", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.relu_type = relu_type
        self.frontend3D = nn.Sequential(
            Conv3d(1, 64, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3), bias=False),
            BatchNorm3d(64))
        self.trunk = _Trunk(relu_type)
        set_compute_dtype(self, dtype)

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        B, T = crops.shape[:2]
        x = _act(self.relu_type)(self.frontend3D(crops.permute(0, 4, 1, 2, 3)))  # (B, 64, T, h, w)
        x = F.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        C, h, w = x.shape[1], x.shape[3], x.shape[4]
        x = x.transpose(1, 2).reshape(B * T, C, h, w)  # time folded into the batch
        return self.trunk(x).reshape(B, T, 512)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def mouth_transform(images: torch.Tensor, crop: int = 88) -> torch.Tensor:
    """Grayscale [0, 1] frames (..., H, W) or (..., H, W, 1) -> the centred
    ``crop``^2 patch (smaller frames whole), normalised with the lip-reading
    mean / std, with a channel dim added."""
    if images.shape[-1] == 1:
        images = images[..., 0]
    H, W = images.shape[-2:]
    top, left = max(0, (H - crop) // 2), max(0, (W - crop) // 2)
    patch = images[..., top:top + min(crop, H), left:left + min(crop, W)]
    return ((patch - LIPREAD_MEAN) / LIPREAD_STD)[..., None]


@dataclasses.dataclass
class LipReadingLoss:
    """Feature distance between predicted and ground-truth mouth-crop
    sequences, per frame, with an optional (B, T) validity mask."""

    net: LipReadingNet
    metric: str = "cosine"  # cosine | l1 | l2

    def features(self, crops: torch.Tensor) -> torch.Tensor:
        return self.net(crops)

    def __call__(self, pred_crops: torch.Tensor, gt_crops: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.no_grad():
            fg = self.features(gt_crops)
        return self.from_features(self.features(pred_crops), fg, mask)

    def from_features(self, fp: torch.Tensor, fg: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      mask_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Loss from per-frame features computed once per distinct crop set;
        ``fg`` is detached here. The cosine clamps each side's norm at 1e-8
        on its own, as JAX does (``F.cosine_similarity`` clamps the
        product); the norm is ``jnp.linalg.norm``'s ``sqrt(sum(x * x))``,
        rounded op by op below float32. ``mask_sum`` replaces the mask's
        own count in the masked mean (the global count under dp)."""
        fg = fg.detach()
        if self.metric == "l1":
            per = (fp - fg).abs().mean(-1)
        elif self.metric == "l2":
            per = ((fp - fg) ** 2).mean(-1)
        else:
            fp_n = fp / torch.clamp_min(_norm(fp), 1e-8)
            fg_n = fg / torch.clamp_min(_norm(fg), 1e-8)
            per = 1.0 - (fp_n * fg_n).sum(-1)
        if mask is None:
            return per.mean()
        mask = mask.to(per.dtype)
        return (per * mask).sum() / torch.clamp_min(mask.sum() if mask_sum is None else mask_sum,
                                                    1.0)
