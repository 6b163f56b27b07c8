"""DECA / EMOCA self-supervised training losses, coarse and detail (port of
``avi_talking_tpu/train/deca_losses.py``).

* photometric masked L1 with the reference's normalisation modes
  (gdl/models/DECA.py:1905-1936);
* the code regularisers shape / exp / tex / light (DECA.py:1969-1974) and
  the texture-VAE KL (DecaLosses.py:25-36);
* the landmark losses in their visibility-normalised L1 form, plain and
  weighted (DecaLosses.py:141-168, :255-280), with the eye / lip /
  mouth-corner distances of ``train.landmark_losses``;
* shading whiteness / smoothness and albedo chromaticity constancy
  (DecaLosses.py:44-93), the ring losses (:96-137, :288-351);
* the detail stage's displacement terms, face-patch L1 and IDMRF over the
  VGG19 taps of ``train.perceptual.Vgg19Features`` (DecaLosses.py:461-546,
  1x1 patches: one cosine-similarity product per sample).

Images are NHWC in [0, 1], as in JAX; the IDMRF features are the tower's
NCHW maps. Patches are resized with ``ops.resize`` (``jax.image.resize``'s
bilinear, which antialiases when it shrinks).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear as _resize_hw

# ----------------------------------------------------------------------------
# photometric + code regularisers
# ----------------------------------------------------------------------------


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor, masks: torch.Tensor,
                     normalization: str = "mean") -> torch.Tensor:
    """Masked L1 with DECA's ``photometric_normalization`` modes."""
    diff = masks * (pred - gt).abs()
    if normalization == "mean":
        return diff.mean()
    dims = tuple(range(1, masks.dim()))
    mu = masks.mean(dim=dims, keepdim=True)
    if normalization == "rel_mask_value":
        return (diff * mu).mean()
    if normalization == "inv_rel_mask_value":
        return (diff / torch.clamp_min(mu, 1e-8)).mean()
    if normalization == "abs_mask_value":
        return (diff * masks.sum(dim=dims, keepdim=True)).mean()
    raise ValueError(f"unknown photometric normalization {normalization!r}")


def shape_reg(code: torch.Tensor) -> torch.Tensor:
    """sum(code^2) / 2; the same form serves exp and tex."""
    return (code ** 2).sum() / 2.0


def light_reg(lightcode: torch.Tensor) -> torch.Tensor:
    """The 9x3 SH coefficients' deviation from their per-band channel mean."""
    return ((lightcode.mean(dim=2, keepdim=True) - lightcode) ** 2).mean()


def kl_loss(texcode: torch.Tensor, mu_dim: int = 128) -> torch.Tensor:
    """Texture-VAE KL: the first ``mu_dim`` dims mu, the rest logvar. The
    coarse tower's 50-d PCA texcode is not a VAE code: a code no wider than
    ``mu_dim`` raises."""
    if texcode.shape[-1] <= mu_dim:
        raise ValueError(f"kl_loss expects a [mu|logvar] code wider than mu_dim={mu_dim}, "
                         f"got {texcode.shape[-1]}-d (the coarse tower's PCA texcode is not a "
                         "VAE code)")
    mu, logvar = texcode[:, :mu_dim], texcode[:, mu_dim:]
    return -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum()


# ----------------------------------------------------------------------------
# landmark losses, the EMOCA coarse forms
# ----------------------------------------------------------------------------


def batch_kp_2d_l1_loss(gt: torch.Tensor, pred: torch.Tensor,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-point L1 weighted by the (re-weighted) visibility gt[..., 2],
    normalised by 2 sum(vis)."""
    vis = gt[..., 2]
    if weights is not None:
        vis = vis * weights[None, :]
    dif = (gt[..., :2] - pred).abs().sum(-1)
    return (dif * vis).sum() / (vis.sum() * 2.0 + 1e-8)


def _with_vis(lmk: torch.Tensor) -> torch.Tensor:
    if lmk.shape[-1] == 2:
        return torch.cat([lmk, lmk.new_ones(*lmk.shape[:-1], 1)], dim=-1)
    return lmk


def deca_landmark_loss(pred: torch.Tensor, gt: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    return batch_kp_2d_l1_loss(_with_vis(gt), pred[..., :2]) * weight


def _deca_lmk_weights() -> np.ndarray:
    w = np.ones((68,), np.float32)
    w[5:7] = 2.0
    w[10:12] = 2.0
    w[27:36] = 1.5
    w[30] = w[31] = w[35] = 3.0
    w[48:60] = 1.5
    w[60:68] = 1.5
    w[48] = w[54] = 3.0
    return w


def deca_weighted_landmark_loss(pred: torch.Tensor, gt: torch.Tensor,
                                weight: float = 1.0) -> torch.Tensor:
    """The live weighted landmark loss: jaw x2, nose x1.5 / x3, mouth x1.5 /
    x3, visibility-normalised."""
    w = torch.from_numpy(_deca_lmk_weights()).to(pred.device)
    return batch_kp_2d_l1_loss(_with_vis(gt), pred[..., :2], w) * weight


# ----------------------------------------------------------------------------
# shading / albedo regularisers, NHWC
# ----------------------------------------------------------------------------


def shading_white_loss(shading: torch.Tensor) -> torch.Tensor:
    rgb = shading.mean(dim=(0, 1, 2))
    return ((rgb - 0.99) ** 2).mean()


def shading_smooth_loss(shading: torch.Tensor) -> torch.Tensor:
    """dx along W on the interior rows, dy along H on the interior columns."""
    dx = shading[:, 1:-1, 1:, :] - shading[:, 1:-1, :-1, :]
    dy = shading[:, 1:, 1:-1, :] - shading[:, :-1, 1:-1, :]
    return (dx ** 2).mean() + (dy ** 2).mean()


def albedo_constancy_loss(albedo: torch.Tensor, alpha: float = 15.0,
                          weight: float = 1.0) -> torch.Tensor:
    """Chromaticity-weighted neighbour smoothness of the UV albedo; the
    weights take no gradient."""
    chrom = albedo / (albedo.sum(dim=-1, keepdim=True) + 1e-6)
    wx = torch.exp(-alpha * (chrom[:, 1:] - chrom[:, :-1]) ** 2).detach()
    wy = torch.exp(-alpha * (chrom[:, :, 1:] - chrom[:, :, :-1]) ** 2).detach()
    lx = (albedo[:, 1:] - albedo[:, :-1]) ** 2 * wx
    ly = (albedo[:, :, 1:] - albedo[:, :, :-1]) ** 2 * wy
    return (lx.mean() + ly.mean()) * weight


# ----------------------------------------------------------------------------
# ring losses
# ----------------------------------------------------------------------------


def _triplet(a: torch.Tensor, p: torch.Tensor, n_anchor: torch.Tensor, n: torch.Tensor,
             margin: float) -> torch.Tensor:
    pd = ((a - p) ** 2).sum(dim=1)
    nd = ((n_anchor - n) ** 2).sum(dim=1)
    return F.relu(margin + pd - nd).mean()


def albedo_ring_loss(texcode: torch.Tensor, margin: float, weight: float = 1.0) -> torch.Tensor:
    """Triplet ring loss on (R, B, D) texture codes: the first R - 1
    streams share a subject, the last differs."""
    R = texcode.shape[0]
    total = texcode.new_zeros(())
    for i in range(R - 1):
        for j in range(R - 1):
            total = total + _triplet(texcode[i], texcode[j], texcode[i], texcode[-1], margin)
    return total / ((R - 1) ** 2) * weight


def albedo_same_loss(albedo: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Pairwise MSE across the first R - 1 streams, divided by R as the
    reference divides."""
    R = albedo.shape[0]
    loss = albedo.new_zeros(())
    for i in range(R - 1):
        for j in range(R - 1):
            loss = loss + ((albedo[i] - albedo[j]) ** 2).mean()
    return loss / R * weight


_RING33_PERMS = (
    (0, 1, 3), (0, 1, 4), (0, 1, 5), (0, 2, 3), (0, 2, 4), (0, 2, 5),
    (1, 0, 3), (1, 0, 4), (1, 0, 5), (1, 2, 3), (1, 2, 4), (1, 2, 5),
    (2, 0, 3), (2, 0, 4), (2, 0, 5), (2, 1, 3), (2, 1, 4), (2, 1, 5),
)


def ring_loss(ring_outputs: torch.Tensor, ring_type: str = "51", margin: float = 0.5,
              weight: float = 1.0) -> torch.Tensor:
    """Shape-consistency ring loss over (R, B, D): '51' is 6 same-subject
    streams against 1 different, '33' the 18 listed (a, p, n) triplets."""
    r = ring_outputs
    total = r.new_zeros(())
    if ring_type == "51":
        pairs = [(i, j) for i in range(6) for j in range(6)]
        for i, j in pairs:
            total = total + _triplet(r[i], r[j], r[i], r[-1], margin)
        count = len(pairs)
    elif ring_type == "33":
        for a, p, n in _RING33_PERMS:
            total = total + _triplet(r[a], r[p], r[p], r[n], margin)
        count = len(_RING33_PERMS)
    else:
        raise ValueError(f"unknown ring_type {ring_type!r}")
    return total / count * weight


# ----------------------------------------------------------------------------
# detail-stage terms
# ----------------------------------------------------------------------------


def z_reg(uv_z: torch.Tensor) -> torch.Tensor:
    return uv_z.abs().mean()


def binary_erosion_mask(mask: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """scipy's binary erosion with a full kernel and a zero border, NHWC
    floats in {0, 1}: 1 only where the whole k x k neighbourhood is 1."""
    pad = kernel_size // 2
    x = F.pad(mask.permute(0, 3, 1, 2), (pad, pad, pad, pad))
    eroded = -F.max_pool2d(-x, kernel_size, stride=1)
    return (eroded > 0.5).to(mask.dtype).permute(0, 2, 3, 1)


def z_symmetry_loss(uv_z: torch.Tensor, uv_vis_mask: torch.Tensor) -> torch.Tensor:
    """Left / right symmetry outside the eroded visible region:
    sum((1 - erode(vis)) * |z - flip_w(z)|), the flipped map detached."""
    nonvis = 1.0 - binary_erosion_mask(uv_vis_mask)
    return (nonvis * (uv_z - torch.flip(uv_z, dims=(2,)).detach()).abs()).sum()


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC ``jax.image.resize(x, (B, h, w, C), "bilinear")``."""
    return _resize_hw(x.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)


# face-attention patches as UV-square fractions (x0, x1, y0, y1), stand-ins
# for the reference's face_attr_mask asset (eyes / nose / mouth)
DEFAULT_FACE_ATTR_PATCHES = (
    (0.15, 0.85, 0.25, 0.55),  # eye band
    (0.35, 0.65, 0.40, 0.75),  # nose
    (0.25, 0.75, 0.60, 0.90),  # mouth
)


def detail_patch_losses(
    uv_texture: torch.Tensor,  # (B, H, W, 3) detail-shaded UV texture
    uv_texture_gt: torch.Tensor,  # (B, H, W, 3) image sampled into UV space
    uv_vis_mask: torch.Tensor,  # (B, H, W, 1)
    sfsw=(1.0, 1.0, 1.0),
    patches=DEFAULT_FACE_ATTR_PATCHES,
    patch_size: int = 256,
    idmrf: Optional["IDMRFLoss"] = None,
    vgg_apply: Optional[Callable[[torch.Tensor], Mapping[str, torch.Tensor]]] = None,
    mrfwr: float = 5e-2,
) -> Dict[str, torch.Tensor]:
    """Per-patch masked L1 (and IDMRF given ``idmrf`` and ``vgg_apply``, a
    tower over NCHW images) between the detail-shaded UV texture and the
    UV-unwrapped input."""
    H, W = uv_texture.shape[1:3]
    terms: Dict[str, torch.Tensor] = {}
    for pi, (x0, x1, y0, y1) in enumerate(patches):
        if not sfsw[pi]:
            continue
        xs, xe = int(x0 * W), max(int(x1 * W), int(x0 * W) + 1)
        ys, ye = int(y0 * H), max(int(y1 * H), int(y0 * H) + 1)
        tp, gp, mp = (resize_bilinear(t[:, ys:ye, xs:xe], patch_size, patch_size)
                      for t in (uv_texture, uv_texture_gt, uv_vis_mask))
        terms[f"detail_l1_{pi}"] = (tp * mp - gp * mp).abs().mean() * sfsw[pi]
        if idmrf is not None and vgg_apply is not None:
            fg = vgg_apply((tp * mp).permute(0, 3, 1, 2))
            ft = vgg_apply((gp * mp).permute(0, 3, 1, 2))
            terms[f"detail_mrf_{pi}"] = idmrf(fg, ft) * sfsw[pi] * mrfwr
    return terms


# ----------------------------------------------------------------------------
# IDMRF
# ----------------------------------------------------------------------------


def _mrf_loss(gen: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """IDMRFLoss.mrf_loss for 1x1 patches on (B, C, H, W) feature maps: the
    reference's conv of 1x1 target patches is the (pixels x pixels) cosine
    similarity product."""
    B, C = gen.shape[:2]
    mean_t = tar.mean(dim=1, keepdim=True)
    g = gen - mean_t
    t = tar - mean_t
    g = g / torch.linalg.vector_norm(g, dim=1, keepdim=True)
    t = t / torch.linalg.vector_norm(t, dim=1, keepdim=True)
    cdist = torch.einsum("bcq,bcp->bqp", t.reshape(B, C, -1), g.reshape(B, C, -1))
    cdist = -(cdist - 1.0) / 2.0
    rel = cdist / (cdist.amin(dim=1, keepdim=True) + 1e-5)
    cs = torch.exp((1.0 - rel) / 0.5)
    cs = cs / cs.sum(dim=1, keepdim=True)
    div_mrf = cs.amax(dim=2).mean(dim=1)
    return (-torch.log(div_mrf)).sum()


@dataclasses.dataclass
class IDMRFLoss:
    """VGG19 relu3_2 / relu4_2 MRF feature matching over the taps of
    ``train.perceptual.Vgg19Features`` (``relu_3_2``, ``relu_4_2``)."""

    style_layers: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"relu_3_2": 1.0, "relu_4_2": 1.0})
    content_layers: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"relu_4_2": 1.0})

    def __call__(self, feats_gen: Mapping[str, torch.Tensor],
                 feats_tar: Mapping[str, torch.Tensor]) -> torch.Tensor:
        style = sum(w * _mrf_loss(feats_gen[k], feats_tar[k])
                    for k, w in self.style_layers.items())
        content = sum(w * _mrf_loss(feats_gen[k], feats_tar[k])
                      for k, w in self.content_layers.items())
        return style + content


# ----------------------------------------------------------------------------
# the coarse stage's weights and loss set
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecaLossWeights:
    """Coarse-stage weights (EMOCA / DECA config defaults)."""

    landmark: float = 1.0
    eye_distance: float = 0.5
    lip_distance: float = 0.5
    mouth_corner: float = 0.0
    photometric: float = 2.0
    shape: float = 1e-4
    expression: float = 1e-4
    tex: float = 1e-4
    light: float = 1.0
    shading_white: float = 10.0
    shading_smooth: float = 10.0
    albedo_constancy: float = 10.0
    emonet: float = 0.0
    idmrf: float = 0.0


def coarse_losses(codedict: Mapping[str, torch.Tensor],
                  weights: DecaLossWeights = DecaLossWeights(),
                  use_weighted_landmarks: bool = True) -> Dict[str, torch.Tensor]:
    """The coarse self-supervised terms, weighted; their sum is the loss.
    ``codedict``: predicted_landmarks (B, 68, 2), lmk (B, 68, 2 or 3),
    predicted_images / images (B, H, W, 3), masks (B, H, W, 1), and where
    present shading (B, H, W, 3), albedo (B, Ht, Wt, 3), shapecode /
    expcode / texcode (B, D), lightcode (B, 9, 3)."""
    from .landmark_losses import eyed_loss, lipd_loss, mouth_corner_loss

    terms: Dict[str, torch.Tensor] = {}
    pred_lmk, lmk = codedict["predicted_landmarks"], codedict["lmk"]
    lmk_fn = deca_weighted_landmark_loss if use_weighted_landmarks else deca_landmark_loss
    terms["landmark"] = lmk_fn(pred_lmk, lmk) * weights.landmark
    terms["eye_distance"] = eyed_loss(pred_lmk, lmk) * weights.eye_distance
    terms["lip_distance"] = lipd_loss(pred_lmk, lmk) * weights.lip_distance
    if weights.mouth_corner:
        terms["mouth_corner"] = mouth_corner_loss(pred_lmk, lmk) * weights.mouth_corner
    terms["photometric"] = photometric_loss(codedict["predicted_images"], codedict["images"],
                                            codedict["masks"]) * weights.photometric
    terms["shape_reg"] = shape_reg(codedict["shapecode"]) * weights.shape
    terms["expression_reg"] = shape_reg(codedict["expcode"]) * weights.expression
    if "texcode" in codedict:
        terms["tex_reg"] = shape_reg(codedict["texcode"]) * weights.tex
    if "lightcode" in codedict:
        terms["light_reg"] = light_reg(codedict["lightcode"]) * weights.light
    if "shading" in codedict:
        terms["shading_white"] = shading_white_loss(codedict["shading"]) * weights.shading_white
        terms["shading_smooth"] = shading_smooth_loss(codedict["shading"]) * weights.shading_smooth
    if "albedo" in codedict:
        terms["albedo_constancy"] = (albedo_constancy_loss(codedict["albedo"])
                                     * weights.albedo_constancy)
    return terms
