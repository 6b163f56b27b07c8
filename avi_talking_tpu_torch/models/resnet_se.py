"""ResNetSE audio embedding encoder, a PD-FGC support net (port of
``avi_talking_tpu/models/resnet_se.py``, NCHW).

The reference's voxceleb-style audio encoder: log-mel (B, 1, n_mels, T) ->
3x3 conv stem -> four SE-BasicBlock stages (strides 1 / 2 / 2 / 2) ->
the channel-major flatten (B, C * mel', T') -> self-attentive pooling over
time (SAP, or ASP with the attentive std) -> Linear to ``n_out``.

The reference's layout, kept for its state dict:
- the stem conv has a bias and runs conv -> ReLU -> BN;
- in a block conv1 -> ReLU -> bn1, but conv2 -> bn2 -> SE, then the
  residual and a ReLU;
- the SE gate squeezes over (H, W) through ``se.fc.0`` / ``se.fc.2``
  (reduction 8);
- ``attention``: Conv1d(C * mel' -> 128, 1) -> ReLU -> BatchNorm1d ->
  Conv1d(128 -> C * mel', 1), then a softmax over time.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..infra.checkpoint import own_state


class SELayer(nn.Module):
    """Squeeze-and-excitation channel gate."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction), nn.ReLU(),
                                nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    """conv1 -> relu -> bn1 -> conv2 -> bn2 -> SE -> + residual -> relu."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, downsample: bool = False,
                 reduction: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.se = SELayer(planes, reduction)
        self.downsample = (nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(planes)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.se(self.bn2(self.conv2(self.bn1(F.relu(self.conv1(x))))))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNetSE(nn.Module):
    """(B, 1, n_mels, T) log-mel -> (B, n_out) embedding; the defaults are
    the ResNetSE34 configuration of the PD-FGC repository."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 num_filters: Sequence[int] = (32, 64, 128, 256), n_out: int = 512,
                 n_mels: int = 80, encoder_type: str = "SAP"):
        super().__init__()
        if encoder_type not in ("SAP", "ASP"):
            raise ValueError(encoder_type)
        self.encoder_type = encoder_type
        self.conv1 = nn.Conv2d(1, num_filters[0], 3, padding=1)
        self.bn1 = nn.BatchNorm2d(num_filters[0])
        in_planes = num_filters[0]
        for li, (planes, blocks) in enumerate(zip(num_filters, layers)):
            stride = 1 if li == 0 else 2
            stage = []
            for bi in range(blocks):
                down = bi == 0 and (stride != 1 or in_planes != planes)
                stage.append(SEBasicBlock(in_planes, planes, stride if bi == 0 else 1, down))
                in_planes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))
        self.n_stages = len(layers)
        width = num_filters[-1] * (n_mels // 8)
        self.attention = nn.Sequential(nn.Conv1d(width, 128, 1), nn.ReLU(), nn.BatchNorm1d(128),
                                       nn.Conv1d(128, width, 1))
        self.fc = nn.Linear(width * (2 if encoder_type == "ASP" else 1), n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(F.relu(self.conv1(x)))
        for li in range(self.n_stages):
            x = getattr(self, f"layer{li + 1}")(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])  # (B, C * mel', T')
        w = torch.softmax(self.attention(x), dim=2)
        mu = (x * w).sum(dim=2)
        if self.encoder_type == "ASP":
            sg = torch.sqrt(((x * x * w).sum(dim=2) - mu * mu).clamp_min(1e-5))
            mu = torch.cat([mu, sg], dim=1)
        return self.fc(mu)


def resnet_se_state_from_torch(sd: Mapping[str, Any], layers: Sequence[int] = (3, 4, 6, 3),
                               prefix: str = "", **kw) -> Dict[str, torch.Tensor]:
    """A reference ``ResNetSE`` state dict (under ``prefix``) -> ``ResNetSE``'s
    state; the widths are the file's (``num_filters``, ``n_out``, ``n_mels``,
    ``encoder_type`` from its shapes)."""
    g = lambda k: torch.as_tensor(sd[prefix + k])
    filters = [int(g(f"layer{li + 1}.0.conv1.weight").shape[0]) for li in range(len(layers))]
    width = int(g("attention.0.weight").shape[1])
    asp = int(g("fc.weight").shape[1]) == 2 * width
    with torch.device("meta"):
        want = ResNetSE(layers, filters, int(g("fc.weight").shape[0]),
                        8 * (width // filters[-1]), "ASP" if asp else "SAP")
    return own_state(want, sd, prefix)
