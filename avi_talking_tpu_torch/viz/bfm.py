"""BFM09 / Deep3DFaceRecon 3DMM visualizer, the reference's "d3dfr" path
(port of ``avi_talking_tpu/viz/bfm.py``).

A 257-d Deep3DFaceRecon coefficient vector [id 80 | exp 64 | tex 80 |
euler 3 | SH gamma 27 | translation 3] decodes to a coloured mesh, which
is projected in perspective (focal 1015 * 256 / 224, camera at (0, 0, 10))
and rendered through ``viz.rasterizer.rasterize_auto`` at ``cap`` 4096:
BFM09's front face has about 70k faces, so it takes the binned route, K2
on the card and its plain version on the CPU. The decode is a batch of
blendshape matrix products over ``BfmAssets``.

``D3dfrReconNet`` is the coefficient encoder (ReconNetWrapper): the
port's ResNet-50 trunk and zero-initialised 1x1-conv heads
(``final_layers.{i}``), concatenated in ``split_coeffs``'s order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infra.checkpoint import own_state
from ..models.resnet import ResNet50
from .rasterizer import rasterize_auto, safe_unit

BFM_COEFF_DIM = 257
D3DFR_DEFAULT_FOCAL = 1015.0 * 256.0 / 224.0
D3DFR_DEFAULT_IMG_SIZE = 256


@dataclasses.dataclass(frozen=True)
class BfmAssets:
    """BFM09 tensors: meanshape (3V,); id_base (3V, 80); exp_base (3V, 64);
    meantex (3V,); tex_base (3V, 80); tri (F, 3) 0-based; point_buf (V, K)
    0-based face ids per vertex, padded with F (the appended zero-normal
    row); keypoints (68,); optional skinmask (V,)."""

    meanshape: torch.Tensor
    id_base: torch.Tensor
    exp_base: torch.Tensor
    meantex: torch.Tensor
    tex_base: torch.Tensor
    tri: torch.Tensor
    point_buf: torch.Tensor
    keypoints: torch.Tensor
    skinmask: Optional[torch.Tensor] = None

    @property
    def num_vertices(self) -> int:
        return self.meanshape.shape[0] // 3

    def to(self, device) -> "BfmAssets":
        return BfmAssets(**{f.name: (None if getattr(self, f.name) is None
                                     else getattr(self, f.name).to(device))
                            for f in dataclasses.fields(self)})

    @classmethod
    def from_mat(cls, path: str) -> "BfmAssets":
        """``BFM09_model_info.mat``; its 1-based tri / point_buf / keypoints
        shifted to 0-based, as the reference does."""
        from scipy.io import loadmat

        m = loadmat(path)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64))
        return cls(meanshape=f32(m["meanshape"]).reshape(-1), id_base=f32(m["idBase"]),
                   exp_base=f32(m["exBase"]), meantex=f32(m["meantex"]).reshape(-1),
                   tex_base=f32(m["texBase"]), tri=i64(m["tri"]) - 1,
                   point_buf=i64(m["point_buf"]) - 1,
                   keypoints=i64(m["keypoints"]).reshape(-1) - 1,
                   skinmask=f32(m["skinmask"]).reshape(-1))


def split_coeffs(coeffs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(B, 257) -> id (80), exp (64), tex (80), angles (3), gamma (27), trans (3)."""
    return (coeffs[:, :80], coeffs[:, 80:144], coeffs[:, 144:224], coeffs[:, 224:227],
            coeffs[:, 227:254], coeffs[:, 254:257])


def merge_coeffs(id_c, exp_c, tex_c, angles, gamma, trans) -> torch.Tensor:
    return torch.cat([id_c, exp_c, tex_c, angles, gamma, trans], dim=1)


def bfm_shape(assets: BfmAssets, id_c: torch.Tensor, exp_c: torch.Tensor) -> torch.Tensor:
    """(B, 80), (B, 64) -> (B, V, 3) vertices, centred on the meanshape's
    centroid."""
    flat = id_c @ assets.id_base.T + exp_c @ assets.exp_base.T + assets.meanshape[None]
    vs = flat.reshape(id_c.shape[0], -1, 3)
    return vs - assets.meanshape.reshape(1, -1, 3).mean(dim=1, keepdim=True)


def bfm_texture(assets: BfmAssets, tex_c: torch.Tensor) -> torch.Tensor:
    """(B, 80) -> (B, V, 3) albedo in [0, 255]."""
    return (tex_c @ assets.tex_base.T + assets.meantex[None]).reshape(tex_c.shape[0], -1, 3)


def euler_rotation(angles: torch.Tensor) -> torch.Tensor:
    """(B, 3) XYZ Euler angles -> (B, 3, 3) = (Rz Ry Rx)^T, for row vectors."""
    sx, sy, sz = (torch.sin(angles[:, i]) for i in range(3))
    cx, cy, cz = (torch.cos(angles[:, i]) for i in range(3))
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    rx = torch.stack([o, z, z, z, cx, -sx, z, sx, cx], -1).reshape(-1, 3, 3)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(-1, 3, 3)
    rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o], -1).reshape(-1, 3, 3)
    return (rz @ ry @ rx).transpose(1, 2)


def rigid_transform(vs: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    return vs @ rot + trans[:, None, :]


def bfm_vertex_normals(assets: BfmAssets, vs: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals through the per-vertex face lists: the
    un-normalised face normals (v1 - v2) x (v2 - v3), a zero row appended
    for the padding, summed over ``point_buf``, then normalised."""
    tri = assets.tri
    v1, v2, v3 = vs[:, tri[:, 0]], vs[:, tri[:, 1]], vs[:, tri[:, 2]]
    face_norm = torch.cross(v1 - v2, v2 - v3, dim=-1)
    face_norm = torch.cat([face_norm, torch.zeros_like(face_norm[:, :1])], dim=1)
    return safe_unit(face_norm[:, assets.point_buf].sum(dim=2), 1e-12)


_A0 = np.pi
_A1 = 2.0 * np.pi / np.sqrt(3.0)
_A2 = 2.0 * np.pi / np.sqrt(8.0)
_C0 = 1.0 / np.sqrt(4.0 * np.pi)
_C1 = np.sqrt(3.0) / np.sqrt(4.0 * np.pi)
_C2 = 3.0 * np.sqrt(5.0) / np.sqrt(12.0 * np.pi)
_D0 = 0.5 / np.sqrt(3.0)


def bfm_sh_basis(normals: torch.Tensor) -> torch.Tensor:
    """(..., 3) normals -> (..., 9), d3dfr's SH basis (its signs and order
    differ from DECA's in ``viz.shading``)."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    return torch.stack([torch.full_like(nx, _A0 * _C0), -_A1 * _C1 * ny, _A1 * _C1 * nz,
                        -_A1 * _C1 * nx, _A2 * _C2 * nx * ny, -_A2 * _C2 * ny * nz,
                        _A2 * _C2 * _D0 * (3.0 * nz ** 2 - 1.0), -_A2 * _C2 * nx * nz,
                        _A2 * _C2 * 0.5 * (nx ** 2 - ny ** 2)], dim=-1)


def add_illumination(face_texture: torch.Tensor, normals: torch.Tensor,
                     gamma: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) albedo x SH lighting from (B, 27) gamma, +0.8 on the DC term."""
    g = gamma.reshape(-1, 3, 9)
    g = torch.cat([g[:, :, :1] + 0.8, g[:, :, 1:]], dim=2)
    lighting = torch.einsum("bvk,bck->bvc", bfm_sh_basis(normals), g)
    return face_texture * lighting


def project_vs(vs: torch.Tensor, focal: float = D3DFR_DEFAULT_FOCAL,
               img_size: int = D3DFR_DEFAULT_IMG_SIZE) -> torch.Tensor:
    """(B, V, 3) -> (B, V, 2) pinhole projection, camera at (0, 0, 10), z
    reversed; y up."""
    cam = vs * vs.new_tensor([1.0, 1.0, -1.0]) + vs.new_tensor([0.0, 0.0, 10.0])
    half = img_size // 2
    return torch.stack([focal * cam[..., 0] / cam[..., 2] + half,
                        focal * cam[..., 1] / cam[..., 2] + half], dim=-1)


def bfm_decode(assets: BfmAssets, coeffs: torch.Tensor, focal: float = D3DFR_DEFAULT_FOCAL,
               img_size: int = D3DFR_DEFAULT_IMG_SIZE) -> Dict[str, torch.Tensor]:
    """(B, 257) -> vs (world), vs_t (posed), lms_proj (68, 2; y flipped to
    image rows), texture, color and gray_color (SH-lit, [0, 255])."""
    id_c, exp_c, tex_c, angles, gamma, trans = split_coeffs(coeffs)
    vs = bfm_shape(assets, id_c, exp_c)
    rot = euler_rotation(angles)
    vs_t = rigid_transform(vs, rot, trans)
    lms = project_vs(vs_t[:, assets.keypoints], focal, img_size)
    lms = torch.stack([lms[..., 0], img_size - lms[..., 1]], dim=-1)
    tex = bfm_texture(assets, tex_c)
    norm = bfm_vertex_normals(assets, vs) @ rot  # normals of the unposed mesh, rotated
    return {"vs": vs, "vs_t": vs_t, "lms_proj": lms, "texture": tex,
            "color": add_illumination(tex, norm, gamma),
            "gray_color": add_illumination(torch.full_like(tex, 127.0), norm, gamma)}


def render_bfm(assets: BfmAssets, coeffs: torch.Tensor, img_size: int = D3DFR_DEFAULT_IMG_SIZE,
               focal: float = D3DFR_DEFAULT_FOCAL, gray: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 257) -> ((B, H, W, 3) render clamped to [0, 255], (B, H, W) mask):
    NDC x / y from the projection (y up), camera-frame depth as z (smaller
    is closer), rasterised at ``cap`` 4096 faces a tile."""
    out = bfm_decode(assets, coeffs, focal, img_size)
    vs_t = out["vs_t"]
    ndc = torch.cat([2.0 * project_vs(vs_t, focal, img_size) / img_size - 1.0,
                     (10.0 - vs_t[..., 2])[..., None]], dim=-1)
    color = out["gray_color"] if gray else out["color"]
    img, mask = rasterize_auto(ndc, assets.tri, color, img_size, img_size, cap=4096)
    return img.clamp(0.0, 255.0), mask


class Visualizer3dmmBfm:
    """A batch of coefficient vectors -> rendered frames (the reference's
    ``Visualizer3DMM``)."""

    def __init__(self, assets: BfmAssets, img_size: int = D3DFR_DEFAULT_IMG_SIZE,
                 focal: Optional[float] = None):
        self.assets = assets
        self.img_size = img_size
        self.focal = float(focal if focal is not None else 1015.0 * img_size / 224.0)

    @torch.no_grad()
    def __call__(self, coeffs: torch.Tensor) -> torch.Tensor:
        return render_bfm(self.assets, coeffs, self.img_size, self.focal)[0]


class _ZeroHead(nn.Conv2d):
    """A 1x1-conv head initialised to zero, as ReconNetWrapper's."""

    def init_own_(self) -> None:
        self.weight.zero_()
        self.bias.zero_()


class D3dfrReconNet(nn.Module):
    """(B, 3, H, W) images -> (B, 257) BFM coefficients."""

    def __init__(self, head_dims: Tuple[int, ...] = (80, 64, 80, 3, 27, 2, 1)):
        super().__init__()
        self.backbone = ResNet50()
        self.final_layers = nn.ModuleList(_ZeroHead(2048, d, 1) for d in head_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.backbone(x)
        return torch.cat([F.linear(feat, h.weight.flatten(1), h.bias) for h in self.final_layers],
                         dim=-1)


def d3dfr_state_from_torch(sd: Mapping[str, Any], prefix: str = "",
                           head_dims: Tuple[int, ...] = (80, 64, 80, 3, 27, 2, 1),
                           heads_key: str = "final_layers") -> Dict[str, torch.Tensor]:
    """A ReconNetWrapper state dict -> ``D3dfrReconNet``'s state.
    ``heads_key`` is ``final_layers`` for ReconNetWrapper and ``fianl_layers``
    (sic) for ResNet50_nofc."""
    with torch.device("meta"):
        want = D3dfrReconNet(head_dims)
    out = {"backbone." + k: v for k, v in own_state(want.backbone, sd, prefix + "backbone.").items()}
    for i in range(len(head_dims)):
        for p in ("weight", "bias"):
            out[f"final_layers.{i}.{p}"] = torch.as_tensor(sd[f"{prefix}{heads_key}.{i}.{p}"])
    return out
