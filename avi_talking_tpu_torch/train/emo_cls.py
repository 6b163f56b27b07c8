"""Stage-1 emotion-classification loss on rendered predicted vertices
(port of ``avi_talking_tpu/train/emo_cls.py``).

Every ``stride``-th predicted frame is projected by the fixed orthographic
camera, rendered as a normal map (``viz.rasterizer.render_normal_maps``: on
the card through the kernel route, K2 for visibility, with the gradient
reaching the vertices through the interpolation), resized to the frozen FAN
backbone's input where the sizes differ, classified by the
Linear(512, 128)-ReLU-BatchNorm1d-Linear(128, 8) head and scored by
cross-entropy against the clip's MEAD emotion label (-1 masks a clip).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.projection import batch_orth_proj
from ..infra.device import resolve_device
from ..infra.init import random_module
from ..models.fan_encoder import FanEncoder
from ..models.flint import RunningStatsBatchNorm1d
from ..viz.rasterizer import render_normal_maps

# the reference's emo2idx
EMO2IDX = {
    "neutral": 0, "angry": 1, "contempt": 2, "disgusted": 3,
    "fear": 4, "happy": 5, "sad": 6, "surprised": 7,
}


class EmoClsHead(nn.Sequential):
    """The reference's custom_emonet_head, Linear(512, 128)-ReLU-
    BatchNorm1d-Linear(128, n_classes), under its names (``0``, ``2``,
    ``3``). The BatchNorm normalises by its running statistics, as JAX's
    ``use_running_average=True``, in a form autograd reaches: the pretrain
    stage trains them as weights (``emo_cls_trainables``)."""

    def __init__(self, n_classes: int = 8):
        super().__init__(nn.Linear(512, 128), nn.ReLU(), RunningStatsBatchNorm1d(128, eps=1e-5),
                         nn.Linear(128, n_classes))

    @classmethod
    def random_init(cls, seed: int = 0, device=None) -> "EmoClsHead":
        """Seeded random weights; ``device=None`` means CUDA."""
        return random_module(cls, resolve_device(device), torch.Generator().manual_seed(seed))


def emo_cls_trainables(head: EmoClsHead) -> List[torch.Tensor]:
    """What JAX's ``optax.adam`` over the head's variables trains in the
    pretrain stage: its parameters and its BatchNorm's running mean and
    variance, all set to require grad here."""
    bn = head[2]
    return [t.requires_grad_() for t in (*head.parameters(), bn.running_mean, bn.running_var)]


@dataclasses.dataclass
class EmoClsLoss:
    """Callable (pred_verts (B, T, V*3), emo_label (B,) int) -> scalar
    cross-entropy. The FAN tower and the head are frozen (set to take no
    gradient here); the gradient reaches the predicted vertices through the
    rendered images."""

    faces: torch.Tensor
    fan: FanEncoder
    head: EmoClsHead
    camera: Sequence[float] = (8.0, 0.0, -0.01)
    render_size: int = 224
    fan_size: int = 224
    stride: int = 20  # frames 0, stride, 2 * stride, ...

    def __post_init__(self):
        self.fan.requires_grad_(False)
        self.head.requires_grad_(False)

    def ndc(self, pred_verts: torch.Tensor) -> torch.Tensor:
        """The sampled frames' vertices in the renderer's NDC, (B * S, V, 3)."""
        v = pred_verts[:, ::self.stride].reshape(-1, pred_verts.shape[-1] // 3, 3)
        cam = torch.tensor([list(self.camera)], dtype=v.dtype, device=v.device).expand(
            v.shape[0], 3)
        proj = batch_orth_proj(v, cam)
        return torch.stack([proj[..., 0], -proj[..., 1], -proj[..., 2]], dim=-1)

    def images(self, pred_verts: torch.Tensor) -> torch.Tensor:
        """The rendered frames, (B * S, 3, fan_size, fan_size)."""
        imgs = render_normal_maps(self.ndc(pred_verts), self.faces, self.render_size,
                                  self.render_size)
        imgs = imgs.permute(0, 3, 1, 2)
        if self.fan_size != self.render_size:  # jax.image.resize: antialiased when it shrinks
            imgs = F.interpolate(imgs, size=(self.fan_size, self.fan_size), mode="bilinear",
                                 align_corners=False, antialias=True)
        return imgs

    def __call__(self, pred_verts: torch.Tensor, emo_label: torch.Tensor,
                 head: Optional[EmoClsHead] = None) -> torch.Tensor:
        """``head`` replaces the frozen head, and the render and FAN then run
        without a gradient: the pretrain stage, where only the head learns."""
        S = -(-pred_verts.shape[1] // self.stride)
        if head is None:
            head = self.head
            feat = self.fan.backbone_feature(self.images(pred_verts))
        else:
            with torch.no_grad():
                feat = self.fan.backbone_feature(self.images(pred_verts))
        logits = head(feat)
        labels = emo_label.long().repeat_interleave(S)
        valid = (labels >= 0).to(logits.dtype)  # -1: a clip without a label
        ce = F.cross_entropy(logits, labels.clamp_min(0), reduction="none")
        return (ce * valid).sum() / valid.sum().clamp_min(1.0)
