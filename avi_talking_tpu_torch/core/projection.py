"""Camera projection (port of ``avi_talking_tpu/core/projection.py``).

``batch_orth_proj`` follows DECA's weak-perspective convention:
X_trans = scale * (X[..., :2] + t); the z coordinate is scaled too (the
renderer negates it downstream).
"""

from __future__ import annotations

import torch


def batch_orth_proj(X: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points, (B, 3) camera [scale, tx, ty] -> (B, N, 3)."""
    camera = camera[:, None, :]
    X_trans = X[..., :2] + camera[..., 1:]
    X_trans = torch.cat([X_trans, X[..., 2:]], dim=-1)
    return camera[..., :1] * X_trans
