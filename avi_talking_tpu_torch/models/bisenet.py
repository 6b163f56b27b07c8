"""BiSeNet face parsing, the reference's segmentation-mask producer (port
of ``avi_talking_tpu/models/bisenet.py``, NCHW).

face-parsing.PyTorch's BiSeNet on ResNet-18 (512^2, ImageNet-normalised,
19 classes, argmax): trunk taps at strides 8 / 16 / 32, two attention
refinement modules and a global-context head on the 16 / 32 taps (nearest
2x up between them), the stride-8 tap as the spatial path, a feature
fusion module and a 1x1 classifier; the logits go back to the input size
by a bilinear align-corners resize written as two interpolation matrices
(``upsample_bilinear_ac``). ``FaceParser`` turns crops into class maps and
EMOCA's photometric masks: the complement of the {background, ears, hair,
hat, neck, necklace} labels.

Parameter names are the reference's (``cp.resnet.*``, ``cp.arm16`` /
``cp.arm32``, ``cp.conv_head16`` / ``32``, ``cp.conv_avg``, ``ffm.*``,
``conv_out.*``); its auxiliary heads ``conv_out16`` / ``conv_out32`` are
not used at inference and are left out of the import.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infra.checkpoint import own_state
from ..ops.resize import resize_bilinear

DISCARDED_LABELS = (0, 8, 9, 13, 14, 16, 17)  # bg, ears, hair, hat, neck(_l)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ConvBNReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, ks: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, ks, stride=stride, padding=ks // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                                            nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class Resnet18Trunk(nn.Module):
    """Taps at strides 8 (128 ch), 16 (256 ch), 32 (512 ch)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))

    def forward(self, x: torch.Tensor):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        feat8 = self.layer2(self.layer1(x))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinement(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, out_ch, 3)
        self.conv_atten = nn.Conv2d(out_ch, out_ch, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class FeatureFusion(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.convblk = ConvBNReLU(in_ch, out_ch, 1)
        self.conv1 = nn.Conv2d(out_ch, out_ch // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(out_ch // 4, out_ch, 1, bias=False)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(self.conv2(atten)) + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(in_ch, mid_ch, 3)
        self.conv_out = nn.Conv2d(mid_ch, n_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18Trunk()
        self.arm16 = AttentionRefinement(256, 128)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128, 3)
        self.conv_head16 = ConvBNReLU(128, 128, 3)
        self.conv_avg = ConvBNReLU(512, 128, 1)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear align-corners weights."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    pos = np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    w = (pos - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] = 1.0 - w
    m[np.arange(n_out), lo + 1] += w
    return m


def upsample_bilinear_ac(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, H, W), bilinear with aligned corners, as two
    matrix products."""
    mh = torch.from_numpy(linear_matrix(x.shape[2], H)).to(x.device)
    mw = torch.from_numpy(linear_matrix(x.shape[3], W)).to(x.device)
    return torch.matmul(torch.matmul(mh, x), mw.t())


class BiSeNet(nn.Module):
    """(B, 3, H, W) normalised -> the main head's logits (B, n_classes, H, W)."""

    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2:]
        cp = self.cp
        feat8, feat16, feat32 = cp.resnet(x)
        avg = cp.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        f32_up = cp.conv_head32(_up2(cp.arm32(feat32) + avg))
        f16_up = cp.conv_head16(_up2(cp.arm16(feat16) + f32_up))
        out = self.conv_out(self.ffm(feat8, f16_up))
        return upsample_bilinear_ac(out, H, W)


class FaceParser:
    """Chunked face parsing: ``__call__`` takes (T, H, W, 3) crops in [0, 1]
    or uint8 and returns (seg (T, H, W) uint8 class maps, mask (T, H, W)
    float32, the photometric mask). The net runs at ``size`` (512, the
    reference's) and the class map comes back to the input size by nearest
    sampling on the host."""

    def __init__(self, model: BiSeNet, size: int = 512, max_b: int = 4):
        self.model = model
        self.size = size
        self.max_b = max_b
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One chunk (B, H, W, 3) -> (B, size, size) labels."""
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        x = resize_bilinear(x.permute(0, 3, 1, 2), (self.size, self.size))
        mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)[:, None, None]
        std = torch.from_numpy(IMAGENET_STD).to(x.device)[:, None, None]
        return self.model(((x - mean) / std).contiguous()).argmax(dim=1)

    def __call__(self, frames) -> Tuple[np.ndarray, np.ndarray]:
        from ..data.batching import chunked_apply

        T, H, W = frames.shape[:3]
        seg = chunked_apply(self.forward, frames, self.max_b,
                            device=self.device).astype(np.uint8)
        if (H, W) != (self.size, self.size):
            yi = np.clip(np.round(np.linspace(0, self.size - 1, H)), 0,
                         self.size - 1).astype(np.int64)
            xi = np.clip(np.round(np.linspace(0, self.size - 1, W)), 0,
                         self.size - 1).astype(np.int64)
            seg = seg[:, yi][:, :, xi]
        mask = np.logical_not(np.isin(seg, np.asarray(DISCARDED_LABELS))).astype(np.float32)
        return seg, mask


def bisenet_state_from_torch(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A face-parsing.PyTorch BiSeNet state dict -> ``BiSeNet``'s state."""
    with torch.device("meta"):
        want = BiSeNet(int(torch.as_tensor(sd["conv_out.conv_out.weight"]).shape[0]))
    return own_state(want, sd)
