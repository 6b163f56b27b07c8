"""DECA / EMOCA detail branch: UV displacement decoding (port of
``avi_talking_tpu/models/deca_detail.py``).

    E_detail: image -> 128-d detail code (``models.emoca.DecaEncoder``)
    D_detail: cat[jaw 3, exp 50, detail 128] -> ``DetailGenerator`` ->
              (B, 256, 256, 1) UV displacement (tanh * out_scale)
    displacement -> detail normals: displace the UV-space coarse geometry
              along the coarse normals, re-derive normals on the dense UV
              grid, blend by the face mask.

``world2uv`` rasterizes the mesh with its UV coordinates as screen
positions (z = 0 everywhere, so the first face that covers a pixel wins)
through the dense route, as JAX does. The winners depend on the UVs alone,
so one rasterization carries every frame's attributes as channels.

The generator keeps the reference's names (``l1.0``, ``conv_blocks.N``)
and its quirk: ``nn.BatchNorm2d(ch, 0.8)`` sets eps 0.8. Its BatchNorms
read the running statistics in a form autograd reaches, since JAX's detail
stage trains them as weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..infra.checkpoint import own_state
from ..infra.device import resolve_device
from ..infra.init import random_module
from ..ops.layers import Conv2d, Linear
from ..viz.rasterizer import compute_vertex_normals, rasterize
from .flint import RunningStatsBatchNorm1d


class RunningStatsBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d normalising by its running statistics in flax's formula,
    written out so that gradients reach the statistics when they require
    grad (``RunningStatsBatchNorm1d``'s forward over channels first)."""

    compute_dtype = torch.float32
    forward = RunningStatsBatchNorm1d.forward


class DetailGenerator(nn.Module):
    """gdl's DecaDecoder.Generator: latent (B, latent_dim) -> Linear ->
    (B, 128, s, s) -> BatchNorm -> 5 x [bilinear upsample x2, conv3x3,
    BatchNorm (eps 0.8), LeakyReLU 0.2] -> conv3x3 -> tanh * out_scale ->
    (B, out_channels, 32 s, 32 s)."""

    def __init__(self, latent_dim: int = 181, out_channels: int = 1, out_scale: float = 0.01,
                 init_size: int = 8):
        super().__init__()
        self.init_size, self.out_scale = init_size, out_scale
        self.l1 = nn.Sequential(Linear(latent_dim, 128 * init_size ** 2))
        blocks = [RunningStatsBatchNorm2d(128)]
        c_in = 128
        for w in (128, 64, 64, 32, 16):
            blocks += [nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
                       Conv2d(c_in, w, 3, 1, 1), RunningStatsBatchNorm2d(w, 0.8),
                       nn.LeakyReLU(0.2)]
            c_in = w
        blocks += [Conv2d(c_in, out_channels, 3, 1, 1), nn.Tanh()]
        self.conv_blocks = nn.Sequential(*blocks)

    @classmethod
    def random_init(cls, latent_dim: int, init_size: int = 8, seed: int = 1,
                    device=None) -> "DetailGenerator":
        """Seeded random weights; ``device=None`` means CUDA."""
        return random_module(lambda: cls(latent_dim, init_size=init_size), resolve_device(device),
                             torch.Generator().manual_seed(seed))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        s = self.init_size
        h = self.l1(z).reshape(z.shape[0], 128, s, s)
        return self.conv_blocks(h) * self.out_scale

    def trainables(self):
        """What JAX's optimizer over the generator's variables trains: the
        parameters, then every BatchNorm's running mean and variance (set
        to require grad here)."""
        stats = []
        for m in self.modules():
            if isinstance(m, RunningStatsBatchNorm2d):
                stats += [m.running_mean.requires_grad_(), m.running_var.requires_grad_()]
        return list(self.parameters()) + stats


# ----------------------------------------------------------------------------
# UV-space geometry
# ----------------------------------------------------------------------------


def grid_faces(h: int, w: int) -> np.ndarray:
    """Dense triangulation of an h x w grid (DECA's generate_triangles)."""
    idx = np.arange(h * w).reshape(h, w)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]
    t1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    t2 = np.stack([a, c, d], axis=-1).reshape(-1, 3)
    return np.concatenate([t1, t2], axis=0).astype(np.int32)


def world2uv(verts: torch.Tensor, faces: torch.Tensor, uv_coords: torch.Tensor,
             uv_faces: torch.Tensor, size: int = 256) -> torch.Tensor:
    """Per-vertex 3-D values (..., V, 3) rasterized into UV space ->
    (..., size, size, 3), taken per corner so UV seams do not bleed. The
    leading dims ride as channels of one rasterization."""
    lead = verts.shape[:-2]
    faces, uv_faces = faces.long(), uv_faces.long()
    F = uv_faces.shape[0]
    uv_ndc = torch.cat([uv_coords * 2.0 - 1.0, uv_coords.new_zeros(uv_coords.shape[0], 1)], -1)
    v = verts.reshape(-1, *verts.shape[-2:])  # (N, V, 3)
    corners = v[:, faces].permute(1, 2, 0, 3).reshape(3 * F, -1)  # (3F, N * 3)
    img, _ = rasterize(uv_ndc[uv_faces].reshape(-1, 3),
                       torch.arange(3 * F, device=verts.device).reshape(F, 3),
                       corners, size, size)
    return img.reshape(size, size, -1, 3).permute(2, 0, 1, 3).reshape(*lead, size, size, 3)


def detail_normals(uv_coarse_verts: torch.Tensor, uv_coarse_normals: torch.Tensor,
                   uv_z: torch.Tensor, uv_face_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, 3) coarse UV geometry and normals, (B, H, W, 1)
    displacement -> (B, H, W, 3) detail normals of the dense UV grid,
    blended with the coarse ones by ``uv_face_mask`` (H, W, 1) where given."""
    B, H, W = uv_z.shape[:3]
    detail_verts = uv_coarse_verts + uv_z * uv_coarse_normals
    dense_faces = torch.from_numpy(grid_faces(H, W)).to(uv_z.device)
    normals = compute_vertex_normals(detail_verts.reshape(B, H * W, 3),
                                     dense_faces).reshape(B, H, W, 3)
    if uv_face_mask is not None:
        normals = normals * uv_face_mask + uv_coarse_normals * (1 - uv_face_mask)
    return normals


@dataclasses.dataclass
class DecaDetailModel:
    """The detail generator with the UV assets: ``decode(jaw, exp,
    detail_code, coarse_verts)`` -> ((B, S, S, 3) UV detail normals, (B, S,
    S, 1) displacement)."""

    generator: DetailGenerator
    faces: torch.Tensor
    uv_coords: torch.Tensor
    uv_faces: torch.Tensor
    uv_size: int = 256
    uv_face_mask: Optional[torch.Tensor] = None

    def uv_geometry(self, verts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, V, 3) coarse vertices -> their UV positions and vertex
        normals, each (B, S, S, 3), from one rasterization."""
        vn = compute_vertex_normals(verts, self.faces)
        uv = world2uv(torch.stack([verts, vn]), self.faces, self.uv_coords, self.uv_faces,
                      self.uv_size)
        return uv[0], uv[1]

    def decode(self, jaw: torch.Tensor, exp: torch.Tensor, detail_code: torch.Tensor,
               coarse_verts: torch.Tensor,
               uv_geometry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``uv_geometry``: ``self.uv_geometry(coarse_verts)`` where the
        caller has it already."""
        uv_z = self.generator(torch.cat([jaw, exp, detail_code], dim=-1)).permute(0, 2, 3, 1)
        uv_v, uv_n = uv_geometry if uv_geometry is not None else self.uv_geometry(coarse_verts)
        return detail_normals(uv_v, uv_n, uv_z, self.uv_face_mask), uv_z


# ----------------------------------------------------------------------------
# reference state dicts
# ----------------------------------------------------------------------------


def detail_generator_state_from_torch(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference Generator's state (``l1.0.*``, ``conv_blocks.N.*`` under
    ``prefix``) -> ``DetailGenerator``'s; the latent width and init_size
    are read from ``l1.0.weight`` ((128 init_size^2, latent))."""
    w = torch.as_tensor(sd[f"{prefix}l1.0.weight"])
    with torch.device("meta"):
        want = DetailGenerator(int(w.shape[1]), init_size=int(round((w.shape[0] / 128) ** 0.5)))
    return own_state(want, sd, prefix)
