"""YUV 4:2:0 frame transport (port of ``avi_talking_tpu/data/yuv.py``):
1.5 bytes a pixel from the host to the card.

One packed uint8 row per frame, ``[Y (H*W) | U (H/2*W/2) | V (H/2*W/2)]``:
ffmpeg's ``-pix_fmt yuv420p`` rawvideo frame, so ``data.videoio`` feeds the
decoder's output here byte for byte. BT.601 full-range (JPEG) coefficients;
the chroma is subsampled by a 2x2 mean and upsampled by a 2x nearest
repeat, on the host (``yuv420_to_rgb_host``, numpy) and on the device
(``yuv420_to_rgb``, torch) alike, so both give the same RGB.
"""

from __future__ import annotations

import numpy as np
import torch

_RGB2Y = np.array([0.299, 0.587, 0.114], np.float32)
_RGB2U = np.array([-0.168736, -0.331264, 0.5], np.float32)
_RGB2V = np.array([0.5, -0.418688, -0.081312], np.float32)


def yuv420_packed_size(h: int, w: int) -> int:
    return h * w + 2 * (h // 2) * (w // 2)


def rgb_to_yuv420(frames_u8: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB, H and W even -> (T, H*W*3/2) packed uint8."""
    if frames_u8.dtype != np.uint8:
        raise ValueError(f"rgb_to_yuv420 wants uint8, got {frames_u8.dtype}")
    t, h, w, c = frames_u8.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"need (T, even H, even W, 3), got {frames_u8.shape}")
    f = frames_u8.astype(np.float32)
    y = f @ _RGB2Y
    u = f @ _RGB2U + 128.0
    v = f @ _RGB2V + 128.0
    u = u.reshape(t, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    v = v.reshape(t, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    return np.concatenate([np.clip(np.rint(p), 0, 255).astype(np.uint8).reshape(t, -1)
                           for p in (y, u, v)], axis=1)


def _split(packed, h: int, w: int, to_float):
    b, hw, qw = packed.shape[0], h * w, (h // 2) * (w // 2)
    return (to_float(packed[:, :hw].reshape(b, h, w)),
            to_float(packed[:, hw:hw + qw].reshape(b, h // 2, w // 2)),
            to_float(packed[:, hw + qw:].reshape(b, h // 2, w // 2)))


def _combine(y, u, v, stack, clip):
    u = u - 128.0
    v = v - 128.0
    rgb = stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v, y + 1.772 * u])
    return clip(rgb) / 255.0


def yuv420_to_rgb_host(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """(T, H*W*3/2) uint8 -> (T, H, W, 3) float32 in [0, 1], numpy."""
    y, u, v = _split(packed, h, w, lambda a: a.astype(np.float32))
    u = u.repeat(2, axis=1).repeat(2, axis=2)
    v = v.repeat(2, axis=1).repeat(2, axis=2)
    return _combine(y, u, v, lambda c: np.stack(c, axis=-1), lambda a: np.clip(a, 0.0, 255.0))


def yuv420_to_rgb(packed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W*3/2) uint8 tensor -> (B, H, W, 3) float32 in [0, 1], where
    the tensor lies."""
    y, u, v = _split(packed, h, w, lambda a: a.float())
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return _combine(y, u, v, lambda c: torch.stack(c, dim=-1), lambda a: a.clamp(0.0, 255.0))
