"""DECA-style landmark losses on the 68-point 2D layout of
``core.flame.FlameModel`` (port of ``avi_talking_tpu/train/landmark_losses.py``):
lip, eye and mouth-corner distances, plain and weighted landmark losses."""

from __future__ import annotations

import torch

# 68-point iBUG landmark index groups (0-based)
_EYE_UP = (37, 38, 43, 44)
_EYE_DOWN = (41, 40, 47, 46)
_LIP_UP = (61, 62, 63)
_LIP_DOWN = (67, 66, 65)
_MOUTH_RIGHT = (48, 60)
_MOUTH_LEFT = (54, 64)


def _pair_dis(landmarks: torch.Tensor, a, b) -> torch.Tensor:
    d = landmarks[:, list(a), :2] - landmarks[:, list(b), :2]
    return torch.sqrt((d ** 2).sum(-1))


def eye_dis(landmarks: torch.Tensor) -> torch.Tensor:
    """(B, 68, >=2) -> (B, 4) vertical eye openings."""
    return _pair_dis(landmarks, _EYE_UP, _EYE_DOWN)


def lip_dis(landmarks: torch.Tensor) -> torch.Tensor:
    """(B, 68, >=2) -> (B, 3) inner-lip openings."""
    return _pair_dis(landmarks, _LIP_UP, _LIP_DOWN)


def mouth_corner_dis(landmarks: torch.Tensor) -> torch.Tensor:
    """(B, 68, >=2) -> (B, 2) mouth widths."""
    return _pair_dis(landmarks, _MOUTH_RIGHT, _MOUTH_LEFT)


def eyed_loss(pred_landmarks: torch.Tensor, gt_landmarks: torch.Tensor) -> torch.Tensor:
    return (eye_dis(pred_landmarks) - eye_dis(gt_landmarks)).abs().mean()


def lipd_loss(pred_landmarks: torch.Tensor, gt_landmarks: torch.Tensor) -> torch.Tensor:
    return (lip_dis(pred_landmarks) - lip_dis(gt_landmarks)).abs().mean()


def mouth_corner_loss(pred_landmarks: torch.Tensor, gt_landmarks: torch.Tensor) -> torch.Tensor:
    return (mouth_corner_dis(pred_landmarks) - mouth_corner_dis(gt_landmarks)).abs().mean()


def landmark_loss(pred_landmarks: torch.Tensor, gt_landmarks: torch.Tensor) -> torch.Tensor:
    """Plain L2 over the 2D coordinates."""
    return ((pred_landmarks[:, :, :2] - gt_landmarks[:, :, :2]) ** 2).mean()


def weighted_landmark_loss(pred_landmarks: torch.Tensor,
                           gt_landmarks: torch.Tensor) -> torch.Tensor:
    """Landmark L1 with DECA's weights: nose x2 (x6 at 31 and 35), mouth x4
    (x8 at the corners 48 and 54)."""
    w = pred_landmarks.new_ones(68)
    w[27:36] = 2.0
    w[[31, 35]] = 6.0
    w[48:68] = 4.0
    w[[48, 54]] = 8.0
    d = (pred_landmarks[:, :, :2] - gt_landmarks[:, :, :2]).abs().sum(-1)
    return (d * w[None]).mean()
