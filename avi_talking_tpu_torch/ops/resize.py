"""Bilinear image resize with ``jax.image.resize(..., "bilinear")``'s
semantics (half-pixel centres, antialiased when it shrinks).

JAX resizes by contracting each resized axis with a weight matrix: the
triangle kernel at the output's sample positions, widened by the scale
when the axis shrinks (a low-pass filter, as PIL's), each output's weights
normalised to sum to 1 and zeroed where the sample falls outside the input.
``F.interpolate(mode="bilinear", align_corners=False)`` does not widen the
kernel, and differs by up to 0.63 on an 8 -> 4 halving; the weight
matrices here are JAX's, built on the host in float32 and cast to the
input's dtype, and the contraction is two matmuls (height, then width).
Axes whose size does not change are left as they are, as in JAX.

The PIRender modules use it for the deformation's upsample
(``models/pirender.py``), the perceptual loss's half-scale pyramid
(``train/perceptual.py``), the portrait command's source image and the
video-pair dataset's crops.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s
    ``compute_weight_mat`` for the triangle kernel."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]) in ``x``'s dtype, on its
    device; differentiable in ``x``."""
    H, W = x.shape[-2:]
    out_h, out_w = size
    if out_h != H:
        wh = torch.from_numpy(weight_matrix(H, out_h, antialias)).to(x.device, x.dtype)
        x = torch.matmul(wh.t(), x)
    if out_w != W:
        ww = torch.from_numpy(weight_matrix(W, out_w, antialias)).to(x.device, x.dtype)
        x = torch.matmul(x, ww)
    return x


def resize_image_hwc(img: np.ndarray, size: int) -> np.ndarray:
    """A (H, W, C) float32 host image -> (size, size, C), as
    ``jax.image.resize(img, (size, size, C), "bilinear")``."""
    t = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).permute(2, 0, 1)
    return resize_bilinear(t, (size, size)).permute(1, 2, 0).contiguous().numpy()
