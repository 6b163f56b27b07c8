"""Batch preprocessors, pseudo-GT builders (port of
``avi_talking_tpu/models/preprocessors.py``; inferno's Preprocessors.py):

* ``FlamePreprocessor``: stored FLAME codes -> GT vertices and template;
* ``EmotionRecognitionPreprocessor``: (B, T, H, W, 3) frames -> per-frame
  emotion features and logits of ``models.emoca.EmotionRecognitionModule``;
* ``SpeechEmotionRecognitionPreprocessor``: (B, samples) audio ->
  utterance emotion logits of ``audio.ser.Wav2Vec2SER``.

The EMOCA preprocessor is ``data.preprocess.EmocaPreprocessor``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core.flame import FlameModel


@dataclasses.dataclass
class FlamePreprocessor:
    flame: FlameModel

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """gt_shape (B, n_shape) or (B, T, n_shape), gt_exp (B, T, n_exp),
        gt_jaw (B, T, 3) -> adds gt_vertices (B, T, V, 3), template (B, V, 3)."""
        exp, jaw = batch["gt_exp"], batch["gt_jaw"]
        B, T = exp.shape[:2]
        shape = batch["gt_shape"]
        if shape.dim() == 2:
            shape = shape[:, None].expand(B, T, shape.shape[-1])
        pose = torch.cat([torch.zeros_like(jaw), jaw], dim=-1)
        verts = self.flame.vertices_only(shape.reshape(B * T, -1), exp.reshape(B * T, -1),
                                         pose.reshape(B * T, -1)).reshape(B, T, -1, 3)
        template = self.flame.vertices_only(shape[:, 0], torch.zeros_like(exp[:, 0]))
        return {**batch, "gt_vertices": verts, "template": template}


@dataclasses.dataclass
class EmotionRecognitionPreprocessor:
    """(B, T, H, W, 3) frames -> per-frame emotion features and logits."""

    module: torch.nn.Module  # models.emoca.EmotionRecognitionModule

    def __call__(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, T = frames.shape[:2]
        out = self.module(frames.reshape(B * T, *frames.shape[2:]).permute(0, 3, 1, 2))
        return {"gt_emo_feat_2": out["emo_feat_2"].reshape(B, T, -1),
                "gt_expression_logits": out["expr_classification"].reshape(B, T, -1)}


@dataclasses.dataclass
class SpeechEmotionRecognitionPreprocessor:
    """(B, samples) audio -> utterance emotion logits."""

    ser: torch.nn.Module  # audio.ser.Wav2Vec2SER

    def __call__(self, audio: torch.Tensor, output_len=None) -> Dict[str, torch.Tensor]:
        return {"gt_audio_emotion_logits": self.ser(audio, output_len=output_len)}
