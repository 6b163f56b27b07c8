"""Style conditioning for the talking head (port of
``avi_talking_tpu/models/conditioning.py``): one-hot [expression(8),
intensity(3), identity(32)] plus a 300-d shape code -> Linear -> 128-d
style. The generate path injects the prior's style instead; the encoder's
weights live in the head all the same."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import Linear

AFFECTNET_EMOTIONS = (
    "Neutral", "Happy", "Sad", "Surprise", "Fear", "Disgust", "Anger", "Contempt",
)

# width of StyleCondition.make()'s concat: 8 + 3 + 32 + 300
DEFAULT_CONDITION_DIM = 343


@dataclasses.dataclass(frozen=True)
class StyleCondition:
    """One sample's style condition."""

    expression: torch.Tensor  # (B, n_expression) one-hot
    intensity: torch.Tensor  # (B, n_intensities)
    identity: torch.Tensor  # (B, n_identities)
    shape: Optional[torch.Tensor] = None  # (B, shape_dim)

    @classmethod
    def make(cls, emotion_idx: int = 0, intensity_idx: int = 2, identity_idx: int = 0,
             batch: int = 1, n_expression: int = 8, n_intensities: int = 3,
             n_identities: int = 32, shape_dim: Optional[int] = 300,
             device=None) -> "StyleCondition":
        def onehot(i, n):
            return F.one_hot(torch.tensor([i], device=device), n).float().repeat(batch, 1)

        return cls(
            expression=onehot(emotion_idx, n_expression),
            intensity=onehot(intensity_idx, n_intensities),
            identity=onehot(identity_idx, n_identities),
            shape=torch.zeros(batch, shape_dim, device=device) if shape_dim else None,
        )

    def concat(self) -> torch.Tensor:
        parts = [self.expression, self.intensity, self.identity]
        if self.shape is not None:
            parts.append(self.shape)
        return torch.cat(parts, dim=-1)


class EmotionStyleEncoder(nn.Module):
    """Linear map from the concatenated condition to the style embedding."""

    def __init__(self, input_dim: int = DEFAULT_CONDITION_DIM, output_dim: int = 128,
                 use_bias: bool = True):
        super().__init__()
        self.map = Linear(input_dim, output_dim, bias=use_bias)

    def forward(self, condition: torch.Tensor) -> torch.Tensor:
        return self.map(condition)
