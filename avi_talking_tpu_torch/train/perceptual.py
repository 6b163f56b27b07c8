"""VGG19 multi-scale perceptual and style loss, PIRender's render loss
(port of ``avi_talking_tpu/train/perceptual.py``, NCHW).

The reference's ``loss/perceptual.py`` with ``flame_wo_crop.yaml``'s
settings: VGG19 taps ``relu_1_1`` .. ``relu_5_1``, three scales (each half
the last, ``jax.image.resize``'s antialiased bilinear), L1, and the
optional gram-matrix style term at scale 0 (weight 250). The tower keeps
torchvision's ``vgg19().features`` layout (``features.N``), so its state
dict loads from torchvision's names; the whole tower runs whatever the
taps are, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..infra.device import resolve_device
from ..infra.init import random_module
from ..ops.layers import Conv2d
from ..ops.resize import resize_bilinear

# (out_channels, convs) per stage; relu_k_1 is the first conv of stage k
_VGG19_PLAN = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
ALL_TAPS = ("relu_1_1", "relu_2_1", "relu_3_1", "relu_4_1", "relu_5_1")

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _vgg19_layout():
    """[(features index, kind, tap name)] in torchvision's order; no pool
    after the last stage (JAX's tower has none)."""
    out, idx = [], 0
    for stage, (_, n_convs) in enumerate(_VGG19_PLAN, start=1):
        for ci in range(n_convs):
            out.append((idx, "conv", None))
            out.append((idx + 1, "relu", f"relu_{stage}_{ci + 1}"))
            idx += 2
        if stage < len(_VGG19_PLAN):
            out.append((idx, "pool", None))
        idx += 1
    return out


def apply_imagenet_normalization(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW images -> ImageNet-normalised."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return ((x + 1.0) / 2.0 - mean) / std


class Vgg19Features(nn.Module):
    """(B, 3, H, W) -> {tap: relu activation} for ``taps``."""

    def __init__(self, taps: Sequence[str] = ALL_TAPS):
        super().__init__()
        self.taps = tuple(taps)
        layers, in_ch = [], 3
        plan = iter(ch for ch, n in _VGG19_PLAN for _ in range(n))
        for _, kind, _ in _vgg19_layout():
            if kind == "conv":
                ch = next(plan)
                layers.append(Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self._names = {idx: name for idx, kind, name in _vgg19_layout() if kind == "relu"}

    @classmethod
    def random_init(cls, taps: Sequence[str] = ALL_TAPS, seed: int = 0,
                    device=None) -> "Vgg19Features":
        """Seeded random weights, frozen. ``device=None`` means CUDA."""
        vgg = random_module(lambda: cls(taps), resolve_device(device),
                            torch.Generator().manual_seed(seed))
        return vgg.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = {}
        for idx, layer in enumerate(self.features):
            if isinstance(layer, nn.MaxPool2d) and min(x.shape[-2:]) < 2:
                break  # flax pools to an empty map here, which no tap reads
            x = layer(x)
            if self._names.get(idx) in self.taps:
                feats[self._names[idx]] = x
        return feats


def vgg19_state_from_torch(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """torchvision ``vgg19()`` (or its ``features``) state dict -> the
    tower's: the ``features.N`` convs (JAX's ``vgg19_params_from_torch``)."""
    return {f"features.{idx}.{p}": torch.as_tensor(sd[f"features.{idx}.{p}"]).float()
            for idx, kind, _ in _vgg19_layout() if kind == "conv" for p in ("weight", "bias")}


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C) normalised gram."""
    B, C, H, W = feat.shape
    f = feat.reshape(B, C, H * W)
    return torch.bmm(f, f.transpose(1, 2)) / (H * W * C)


def downsample_half(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] // 2, x.shape[-1] // 2))


@dataclasses.dataclass
class PerceptualLoss:
    """Multi-scale VGG perceptual loss: ``loss(pred, target)``, both NCHW in
    [-1, 1]; the target's side runs without a gradient."""

    model: Vgg19Features
    layers: Sequence[str] = ALL_TAPS
    weights: Optional[Sequence[float]] = None
    num_scales: int = 3
    criterion: str = "l1"
    use_style_loss: bool = False
    style_weight: float = 250.0

    def _dist(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a - b).abs().mean() if self.criterion == "l1" else ((a - b) ** 2).mean()

    def __call__(self, inp: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        weights = self.weights or [1.0] * len(self.layers)
        inp = apply_imagenet_normalization(inp)
        with torch.no_grad():
            target = apply_imagenet_normalization(target)
        loss = 0.0
        style = 0.0
        for scale in range(self.num_scales):
            fi = self.model(inp)
            with torch.no_grad():
                ft = self.model(target)
            for layer, w in zip(self.layers, weights):
                loss = loss + w * self._dist(fi[layer], ft[layer])
                if self.use_style_loss and scale == 0:
                    with torch.no_grad():
                        gt = gram_matrix(ft[layer])
                    style = style + self._dist(gram_matrix(fi[layer]), gt)
            if scale != self.num_scales - 1:
                inp = downsample_half(inp)
                with torch.no_grad():
                    target = downsample_half(target)
        if self.use_style_loss:
            return loss + style * self.style_weight
        return loss
