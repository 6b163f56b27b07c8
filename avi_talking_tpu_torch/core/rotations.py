"""Rotations (port of ``avi_talking_tpu/core/rotations.py``:
``batch_rodrigues`` and ``rot_mat_to_euler_y``)."""

from __future__ import annotations

import torch


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3), with the reference's
    ``+1e-8`` inside the norm."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=1, keepdim=True)  # (N, 1)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[:, None]  # (N, 1, 1)
    sin = torch.sin(angle)[:, None]
    rx, ry, rz = torch.split(rot_dir, 1, dim=1)
    zeros = torch.zeros_like(rx)
    K = torch.cat([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * K + (1.0 - cos) * (K @ K)


def rot_mat_to_euler_y(rot_mats: torch.Tensor) -> torch.Tensor:
    """The y-axis Euler angle of FLAME's dynamic contour landmarks:
    ``atan2(-R[2,0], sqrt(R[0,0]^2 + R[1,0]^2))``."""
    sy = torch.sqrt(rot_mats[..., 0, 0] ** 2 + rot_mats[..., 1, 0] ** 2)
    return torch.atan2(-rot_mats[..., 2, 0], sy)
