"""Axis-angle to rotation matrix (port of
``avi_talking_tpu/core/rotations.py::batch_rodrigues``)."""

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
