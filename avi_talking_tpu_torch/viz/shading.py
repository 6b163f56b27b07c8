"""Spherical-harmonics shading (port of ``avi_talking_tpu/viz/shading.py``):
SRenderY's 9-band SH Lambertian lighting, the grey ``render_shaded``, and
the UV-textured ``render_textured`` / ``render_detailed`` of EMOCA / DECA.

The textured renders rasterize per-corner UV attributes once through
``rasterize_auto(per_corner=True)`` (K2 on the card for the FLAME mesh)
and sample the NHWC texture and normal maps with PIRender's bilinear
sampler through ``sample_nhwc``, the one place that changes their layout.
"""

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


def _default_light(B: int, device) -> torch.Tensor:
    return torch.from_numpy(DEFAULT_LIGHT).to(device).expand(B, 9, 3)


def sample_nhwc(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``grid_sample_bilinear`` on an NHWC image: (B, H, W, C), grid (B, Hg,
    Wg, 2) of (x, y) in [-1, 1] -> (B, Hg, Wg, C)."""
    from ..models.pirender import grid_sample_bilinear

    return grid_sample_bilinear(image.permute(0, 3, 1, 2), grid).permute(0, 2, 3, 1)


def _uv_grid(uv_img: torch.Tensor) -> torch.Tensor:
    """Interpolated UVs in [0, 1] -> a sampling grid in [-1, 1], the v axis
    flipped (UV v points up, image rows down)."""
    grid = uv_img * 2.0 - 1.0
    return torch.stack([grid[..., 0], -grid[..., 1]], dim=-1)


def render_textured(
    vertices_ndc: torch.Tensor,  # (B, V, 3), z = depth
    faces: torch.Tensor,  # (F, 3)
    uvs: torch.Tensor,  # (Tv, 2) in [0, 1]
    face_uvs: torch.Tensor,  # (F, 3) indices into uvs
    texture: torch.Tensor,  # (Ht, Wt, 3) or per frame (B, Ht, Wt, 3), [0, 1]
    height: int = 256,
    width: int = 256,
    sh_coeff: Optional[torch.Tensor] = None,
    background: float = 0.0,
    chunk: int = 2048,
    return_aux: bool = False,
):
    """SRenderY's textured render: one per-corner rasterization carries
    [u v nx ny nz], the texture is sampled at the UVs and lit by SH on the
    interpolated normals. ``return_aux`` also returns what DECA's losses
    read: ``shading``, ``albedo_images``, ``alpha_images``, ``normal_images``."""
    B = vertices_ndc.shape[0]
    faces = faces.long()
    normals = compute_vertex_normals(vertices_ndc, faces)
    corner_uv = uvs[face_uvs.long()]  # (F, 3, 2)
    corner_n = normals[:, faces]  # (B, F, 3, 3)
    attrs = torch.cat([corner_uv.expand(B, *corner_uv.shape), corner_n], dim=-1)
    img, mask = rasterize_auto(vertices_ndc, faces, attrs, height, width, chunk=chunk,
                               per_corner=True)
    tex_b = texture if texture.dim() == 4 else texture.expand(B, *texture.shape)
    albedo = sample_nhwc(tex_b, _uv_grid(img[..., :2]))
    n = safe_unit(img[..., 2:])
    if sh_coeff is None:
        sh_coeff = _default_light(B, vertices_ndc.device)
    shading = add_sh_light(n, sh_coeff)
    out = torch.where(mask[..., None], torch.clamp(albedo * shading / math.pi, 0.0, 1.0),
                      background)
    if return_aux:
        return out, {"shading": shading, "albedo_images": torch.where(mask[..., None], albedo, 0.0),
                     "alpha_images": mask, "normal_images": n}
    return out


def render_detailed(
    vertices_ndc: torch.Tensor,  # (B, V, 3)
    faces: torch.Tensor,  # (F, 3)
    uvs: torch.Tensor,  # (Tv, 2)
    face_uvs: torch.Tensor,  # (F, 3)
    texture: torch.Tensor,  # (B, Ht, Wt, 3) albedo
    normal_map: torch.Tensor,  # (B, Hn, Wn, 3) UV-space detail normals
    height: int = 256,
    width: int = 256,
    sh_coeff: Optional[torch.Tensor] = None,
    background: float = 0.0,
    chunk: int = 2048,
) -> torch.Tensor:
    """DECA's detail render: as ``render_textured``, but the per-pixel
    normals are sampled from the UV-space detail normal map; one
    rasterization of the UVs feeds both lookups."""
    B = vertices_ndc.shape[0]
    corner_uv = uvs[face_uvs.long()]
    img, mask = rasterize_auto(vertices_ndc, faces.long(), corner_uv.expand(B, *corner_uv.shape),
                               height, width, chunk=chunk, per_corner=True)
    grid = _uv_grid(img)
    albedo = sample_nhwc(texture, grid)
    n = safe_unit(sample_nhwc(normal_map, grid))
    if sh_coeff is None:
        sh_coeff = _default_light(B, vertices_ndc.device)
    out = torch.clamp(albedo * add_sh_light(n, sh_coeff) / math.pi, 0.0, 1.0)
    return torch.where(mask[..., None], out, background)


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
        sh_coeff = _default_light(B, vertices_ndc.device)
    shaded = torch.clamp(albedo * add_sh_light(n, sh_coeff) / math.pi, 0.0, 1.0)
    return torch.where(mask[..., None], shaded, background)
