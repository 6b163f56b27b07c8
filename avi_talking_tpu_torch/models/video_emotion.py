"""Video-level emotion recognition and its loss (port of
``avi_talking_tpu/models/video_emotion.py``).

Per-frame emotion features (``emo_feat_2`` of the EmotionRecognitionModule)
-> a linear projection, the sinusoidal positional table, a post-LN
transformer encoder (gelu, exact erf; the plain attention, as JAX's
encoder runs it) and a mean over time -> sequence-level expression logits.
``dtype`` is the compute dtype (``ops.layers``), as JAX's: the projection,
the table (rounded to it), the encoder and the classifier run at it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..ops.layers import Linear, log_softmax, set_compute_dtype
from ..ops.positional import sinusoidal_positional_encoding
from ..ops.transformer import TransformerEncoder


class VideoEmotionClassifier(nn.Module):
    """(B, T, input_dim) per-frame features -> (B, n_classes) logits."""

    def __init__(self, n_classes: int = 8, feature_dim: int = 256, num_layers: int = 2,
                 nhead: int = 8, input_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature_dim = feature_dim
        self.in_proj = Linear(input_dim, feature_dim)
        self.encoder = TransformerEncoder(num_layers, feature_dim, nhead, feature_dim * 2,
                                          activation="gelu")
        self.classifier = Linear(feature_dim, n_classes)
        set_compute_dtype(self, dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.in_proj(feats)
        x = x + sinusoidal_positional_encoding(x.shape[1], self.feature_dim, x.dtype, x.device)
        return self.classifier(self.encoder(x).mean(dim=1))


@dataclasses.dataclass
class VideoEmotionLoss:
    """Cross-entropy to ground-truth labels, or to the softmax of
    ground-truth video logits (detached)."""

    classifier: VideoEmotionClassifier

    def __call__(self, frame_features: torch.Tensor, gt_label: Optional[torch.Tensor] = None,
                 gt_logits: Optional[torch.Tensor] = None) -> torch.Tensor:
        logp = log_softmax(self.classifier(frame_features), dim=-1)
        if gt_logits is not None:
            target = torch.softmax(gt_logits.detach(), dim=-1)
        elif gt_label is not None:
            # jax.nn.one_hot: float32, and a label outside [0, n) gives a row
            # of zeros, so it adds 0 to the sum (F.one_hot would raise,
            # F.cross_entropy would count it); the mean runs over every row
            n = logp.shape[-1]
            target = (gt_label[:, None] == torch.arange(n, device=logp.device)).float()
        else:
            raise ValueError("VideoEmotionLoss needs gt_label or gt_logits")
        return -(target * logp).sum(-1).mean()
