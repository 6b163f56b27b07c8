"""EmoNet-style emotion recognition and its feature loss (port of the
``EmotionRecognitionModule`` and ``EmoNetLoss`` of
``avi_talking_tpu/models/emoca.py``).

``EmotionRecognitionModule`` (EmoCnnModule): ResNet-50 features ->
expression logits (8) + valence + arousal; EMOTE's emotion loss compares
the 2048-d features (``emo_feat_2``) by MSE. The DECA / EMOCA coefficient
encoders (``DecaEncoder``, ``EmocaEncoder``, ``emoca_pseudo_gt``,
``split_deca_code``) are not ported yet (ROADMAP Queue 1, item 5).
``dtype`` is the compute dtype of the backbone and the head, as JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ..ops.layers import Linear, set_compute_dtype
from .resnet import ResNet50


class EmotionRecognitionModule(nn.Module):
    """(N, 3, H, W) images -> {"emo_feat_2": (N, 2048), "expr_classification":
    (N, n_expression), and with ``predict_va`` "valence" / "arousal" (N,)}."""

    def __init__(self, n_expression: int = 8, predict_va: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_expression = n_expression
        self.predict_va = predict_va
        self.backbone = ResNet50()
        self.linear = Linear(2048, n_expression + (2 if predict_va else 0))
        set_compute_dtype(self, dtype)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = self.backbone(images)
        pred = self.linear(feat)
        n = self.n_expression
        out = {"emo_feat_2": feat, "expr_classification": pred[..., :n]}
        if self.predict_va:
            out["valence"] = pred[..., n]
            out["arousal"] = pred[..., n + 1]
        return out


@dataclasses.dataclass
class EmoNetLoss:
    """create_emo_loss's defaults: MSE on ``emo_feat_2`` (plus valence /
    arousal terms when weighted)."""

    module: EmotionRecognitionModule
    feat_weight: float = 1.0
    valence_weight: float = 0.0
    arousal_weight: float = 0.0
    expression_weight: float = 0.0

    def __call__(self, pred_images: torch.Tensor, gt_images: torch.Tensor):
        with torch.no_grad():
            g = self.module(gt_images)
        return self.from_outputs(self.module(pred_images), g)

    def from_outputs(self, p, g):
        """Loss from tower outputs computed once per distinct video set
        (every term means over all batch dims); ``g`` is detached here."""
        g = {k: v.detach() for k, v in g.items()}
        loss = self.feat_weight * ((p["emo_feat_2"] - g["emo_feat_2"]) ** 2).mean()
        metrics = {"emo_feat": loss}
        for name, w in (("valence", self.valence_weight), ("arousal", self.arousal_weight)):
            if w and name in p:
                term = ((p[name] - g[name]) ** 2).mean()
                loss = loss + w * term
                metrics[name] = term
        return loss, metrics
