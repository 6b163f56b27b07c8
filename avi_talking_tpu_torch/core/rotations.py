"""Rotations (port of ``avi_talking_tpu/core/rotations.py``:
``batch_rodrigues``, ``axis_angle_to_matrix``, the 6D representation
(``rotation_6d_to_matrix``, ``matrix_to_rotation_6d``) and
``rot_mat_to_euler_y``)."""

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


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3)."""
    return batch_rodrigues(aa.reshape(-1, 3)).reshape(*aa.shape[:-1], 3, 3)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt (Zhou et al. 2019); the rows
    are b1, b2, b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-2)


def matrix_to_rotation_6d(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6): the first two rows."""
    return mat[..., :2, :].reshape(*mat.shape[:-2], 6)
