"""Landmark-driven face cropping: detect -> centre / size -> warp (port of
``avi_talking_tpu/data/facecrop.py``).

The reference's ``bbox2point`` / ``point2transform`` / ``bbpoint_warp`` as
FaceVideoDataModule drives them (scale 1.25, kpt68 boxes from the FAN
landmarks' extent): landmarks on the full frame, the square face box, a
warp-crop to the encoder's size, and the landmarks carried into crop
space. The warp is an axis-aligned scale and translate, so its bilinear
sampling is separable: one row gather and blend (H -> S), then one column
gather and blend (W -> S), on the frames' device, edge-clamped before the
floor; ``out_u8`` rounds half to even (``torch.round``, JAX's ``rint``) on
the device.

Pixel coordinates are (x right, y down); normalised ones are [-1, 1] with
the same orientation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def bbox2point_kpt68(lmk_px: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 68, 2) landmark pixels -> (old_size (T,), centre (T, 2)): the mean
    box side x 1.1 and the box centre (``bbox2point`` type 'kpt68')."""
    left, right = lmk_px[..., 0].min(-1), lmk_px[..., 0].max(-1)
    top, bottom = lmk_px[..., 1].min(-1), lmk_px[..., 1].max(-1)
    old_size = (right - left + bottom - top) / 2.0 * 1.1
    center = np.stack([right - (right - left) / 2.0, bottom - (bottom - top) / 2.0], axis=-1)
    return old_size.astype(np.float32), center.astype(np.float32)


def bbox2point_bbox(boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 4) [left, top, right, bottom] detector boxes -> (size, centre),
    with the detector box's downward shift (``bbox2point`` type 'bbox')."""
    left, top, right, bottom = [boxes[..., i] for i in range(4)]
    old_size = (right - left + bottom - top) / 2.0
    center = np.stack([right - (right - left) / 2.0,
                       bottom - (bottom - top) / 2.0 + old_size * 0.12], axis=-1)
    return old_size.astype(np.float32), center.astype(np.float32)


def _axis(start: torch.Tensor, side: torch.Tensor, limit: int, S: int):
    """Clamped sample positions along one axis, (T, S) each: i0, i1 and the
    weight of i1."""
    grid = torch.arange(S, dtype=torch.float32, device=start.device) / (S - 1)
    pos = (start[:, None] + grid[None] * side[:, None]).clamp(0.0, limit - 1.0)
    i0 = torch.floor(pos).long()
    return i0, (i0 + 1).clamp_max(limit - 1), pos - i0.float()


def warp_tensor(frames: torch.Tensor, center: torch.Tensor, size: torch.Tensor, S: int,
                out_u8: bool = False) -> torch.Tensor:
    """The warp on tensors of one device: (T, H, W, 3) float in [0, 1] or
    uint8, (T, 2), (T,) -> (T, S, S, 3) float32, or uint8 with ``out_u8``."""
    if frames.dtype == torch.uint8:
        frames = frames.float() / 255.0
    T, H, W, C = frames.shape
    iy0, iy1, wy = _axis(center[:, 1] - size / 2.0, size, H, S)
    ix0, ix1, wx = _axis(center[:, 0] - size / 2.0, size, W, S)
    rows_at = lambda i: frames.gather(1, i[:, :, None, None].expand(T, S, W, C))
    rows = rows_at(iy0) * (1.0 - wy)[..., None, None] + rows_at(iy1) * wy[..., None, None]
    cols_at = lambda i: rows.gather(2, i[:, None, :, None].expand(T, S, S, C))
    out = cols_at(ix0) * (1.0 - wx)[:, None, :, None] + cols_at(ix1) * wx[:, None, :, None]
    if out_u8:
        out = torch.round(out * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    return out


def warp_crop(frames, center, size, out_size: int, out_u8: bool = False,
              device: Optional[torch.device] = None) -> np.ndarray:
    """Batched square crop: (T, H, W, 3), (T, 2), (T,) -> (T, S, S, 3) numpy.

    ``point2transform``'s map: the square [centre - size/2, centre +
    size/2] onto [0, out_size - 1]; bilinear, edge-clamped. ``frames`` is
    numpy (copied to ``device``, the CPU when None) or a tensor, used where
    it lies."""
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(np.ascontiguousarray(frames)).to(device or "cpu")
    dev = frames.device
    c = torch.as_tensor(np.asarray(center, np.float32), device=dev)
    s = torch.as_tensor(np.asarray(size, np.float32), device=dev)
    return warp_tensor(frames, c, s, out_size, out_u8).cpu().numpy()


def landmarks_to_crop_space(lmk_px: np.ndarray, center: np.ndarray, size: np.ndarray,
                            out_size: int) -> np.ndarray:
    """Full-frame landmark pixels -> [-1, 1] of the warped crop."""
    origin = center - size[:, None] / 2.0
    crop_px = (lmk_px - origin[:, None, :]) * ((out_size - 1) / size)[:, None, None]
    return (crop_px / (out_size - 1) * 2.0 - 1.0).astype(np.float32)


def detect_and_crop(detector, frames: np.ndarray, out_size: int = 224, scale: float = 1.25,
                    smooth_boxes: bool = False, box_detector=None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full frames (T, H, W, 3) in [0, 1] -> (crops (T, S, S, 3), crop-space
    landmarks (T, 68, 2) in [-1, 1], validity (T,)): FAN landmarks on the
    full frame (after an S3FD box stage with ``box_detector``) -> kpt68 box
    -> size x ``scale`` -> warp-crop; ``smooth_boxes`` takes the clip's
    median box."""
    lmk_px, scores = detect_fullframe_landmarks(detector, frames, box_detector=box_detector)
    old_size, center = bbox2point_kpt68(lmk_px)
    size = (old_size * scale).astype(np.float32)
    if smooth_boxes:
        size = np.full_like(size, float(np.median(size)))
        center = np.broadcast_to(np.median(center, axis=0, keepdims=True), center.shape).copy()
    crops = warp_crop(frames, center, size, out_size, device=detector.device)
    crop_lmk = landmarks_to_crop_space(lmk_px, center, size, out_size)
    validity = np.clip(scores.mean(-1), 0.0, None).astype(np.float32)
    return crops.astype(np.float32), crop_lmk, validity


def detect_fullframe_landmarks(detector, frames, box_detector=None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Full frames -> (landmark pixels (T, 68, 2), scores (T, 68)).

    With ``box_detector`` (S3FD) the frames go to the device once: the
    top-1 box decode, the box-centred 256 crop (centre raised 0.12 x the
    box height, side 200 / 195 x (w + h), face_alignment's) and FAN all
    read that copy, and only boxes and landmarks come back. Without it FAN
    runs on the whole frame, resized to 256 on the device."""
    T, H, W = frames.shape[:3]
    det_size = 256  # FAN's input size (FaceDetector.optimal_landmark_detector_im_size)
    dev = detector.device
    if box_detector is not None:
        full = (torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
                if isinstance(frames, np.ndarray) else frames)
        boxes = box_detector.best_box_device(full)  # (T, 5)
        bw, bh = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
        center0 = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2.0,
                            (boxes[:, 1] + boxes[:, 3]) / 2.0 - 0.12 * bh], axis=-1)
        side0 = ((bw + bh) * (200.0 / 195.0)).astype(np.float32)
        stage1 = warp_tensor(full, torch.from_numpy(center0.astype(np.float32)).to(dev),
                             torch.from_numpy(side0).to(dev), det_size)
        lmk_ndc, scores = detector(stage1)  # [-1, 1] of the stage-1 crop
        origin = center0 - side0[:, None] / 2.0
        lmk_px = origin[:, None, :] + (lmk_ndc + 1.0) / 2.0 * side0[:, None, None]
    else:
        if (H, W) != (det_size, det_size):
            from ..ops.resize import resize_bilinear

            f = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
            if f.dtype == torch.uint8:
                f = f.float() / 255.0
            det_in = resize_bilinear(f.permute(0, 3, 1, 2), (det_size, det_size)
                                     ).permute(0, 2, 3, 1).contiguous()
        else:
            det_in = frames
        lmk_ndc, scores = detector(det_in)  # [-1, 1] of the resized frame
        rel = (lmk_ndc + 1.0) / 2.0
        lmk_px = np.stack([rel[..., 0] * (W - 1), rel[..., 1] * (H - 1)], -1)
    return lmk_px.astype(np.float32), scores


def smooth_track(center: np.ndarray, size: np.ndarray, validity: Optional[np.ndarray] = None,
                 sigma: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """Stabilise a face-box track (FaceVideoDataModule's detection
    alignment): interpolate over failed-detection gaps (validity 0), then a
    Gaussian of ``sigma`` frames on the centres and sizes (scipy)."""
    from scipy.ndimage import gaussian_filter1d

    T = center.shape[0]
    center = center.astype(np.float64).copy()
    size = size.astype(np.float64).copy()
    if validity is not None:
        good = np.asarray(validity) > 0
        if good.any() and not good.all():
            t = np.arange(T)
            for d in range(2):
                center[:, d] = np.interp(t, t[good], center[good, d])
            size = np.interp(t, t[good], size[good])
    if sigma > 0 and T > 1:
        for d in range(2):
            center[:, d] = gaussian_filter1d(center[:, d], sigma=sigma, mode="nearest")
        size = gaussian_filter1d(size, sigma=sigma, mode="nearest")
    return center.astype(np.float32), size.astype(np.float32)
