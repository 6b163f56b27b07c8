"""Spherical-harmonics shading (port of ``avi_talking_tpu/viz/shading.py``:
SRenderY's 9-band SH Lambertian lighting and the grey ``render_shaded``).
``render_textured`` and ``render_detailed`` need PIRender's bilinear sampler
and come with the EMOCA / PIRender slice."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .rasterizer import compute_vertex_normals, rasterize_auto, safe_unit

# DECA's SH constant factors (pi*c, order 0..2)
_SH_CONST = np.asarray(
    [
        1 / math.sqrt(4 * math.pi),
        2 * math.pi / 3 * math.sqrt(3 / (4 * math.pi)),
        2 * math.pi / 3 * math.sqrt(3 / (4 * math.pi)),
        2 * math.pi / 3 * math.sqrt(3 / (4 * math.pi)),
        math.pi / 4 * 3 * math.sqrt(5 / (12 * math.pi)),
        math.pi / 4 * 3 * math.sqrt(5 / (12 * math.pi)),
        math.pi / 4 * 3 * math.sqrt(5 / (12 * math.pi)),
        math.pi / 4 * (3 / 2) * math.sqrt(5 / (12 * math.pi)),
        math.pi / 4 * (1 / 2) * math.sqrt(5 / (4 * math.pi)),
    ],
    dtype=np.float32,
)

DEFAULT_LIGHT = np.zeros((9, 3), np.float32)
DEFAULT_LIGHT[0] = 3.0  # soft ambient
DEFAULT_LIGHT[2] = 1.0  # frontal directional


def sh_basis(normals: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit normals -> (..., 9) constant-weighted SH basis."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    basis = torch.stack(
        [torch.ones_like(nx), -ny, nz, -nx,
         nx * ny, -ny * nz, 3 * nz ** 2 - 1, -nx * nz, nx ** 2 - ny ** 2],
        dim=-1,
    )
    return basis * torch.from_numpy(_SH_CONST).to(normals.device)


def add_sh_light(normal_images: torch.Tensor, sh_coeff: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normals, (B, 9, 3) light -> (B, H, W, 3) Lambertian shading."""
    return torch.einsum("bhwk,bkc->bhwc", sh_basis(normal_images), sh_coeff)


def render_shaded(
    vertices_ndc: torch.Tensor,  # (B, V, 3), z = depth
    faces: torch.Tensor,
    height: int = 256,
    width: int = 256,
    albedo: float = 0.7,
    sh_coeff: Optional[torch.Tensor] = None,
    background: float = 0.0,
    chunk: int = 2048,
) -> torch.Tensor:
    """DECA ``render_shape`` equivalent: grey SH-lit geometry images."""
    B = vertices_ndc.shape[0]
    normals = compute_vertex_normals(vertices_ndc, faces)
    imgs, mask = rasterize_auto(vertices_ndc, faces, normals, height, width, chunk=chunk)
    n = safe_unit(imgs)
    if sh_coeff is None:
        sh_coeff = torch.from_numpy(DEFAULT_LIGHT).to(vertices_ndc.device).expand(B, 9, 3)
    shaded = torch.clamp(albedo * add_sh_light(n, sh_coeff) / math.pi, 0.0, 1.0)
    return torch.where(mask[..., None], shaded, background)
