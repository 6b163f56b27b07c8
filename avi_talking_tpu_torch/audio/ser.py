"""Speech emotion recognition on wav2vec2 (port of
``avi_talking_tpu/audio/ser.py``): inferno's ``Wav2Vec2SER``, wav2vec2
features -> projector -> mean over time -> classifier logits. K1 runs in
each of the wav2vec2 encoder's layers on the card."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.layers import Linear, set_compute_dtype
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model


class Wav2Vec2SER(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, num_labels: int = 8, classifier_proj_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.wav2vec2 = Wav2Vec2Model(cfg, dtype=dtype)
        self.projector = Linear(cfg.hidden_size, classifier_proj_size)
        self.classifier = Linear(classifier_proj_size, num_labels)
        set_compute_dtype(self, dtype)

    def forward(self, input_values: torch.Tensor, output_len: Optional[int] = None) -> torch.Tensor:
        """(B, samples) 16 kHz audio -> (B, num_labels) logits."""
        feats = self.wav2vec2(input_values, output_len=output_len)
        return self.classifier(self.projector(feats).mean(dim=1))
