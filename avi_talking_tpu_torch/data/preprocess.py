"""Raw frames or videos -> EMOCA-preprocessed MEAD folders (pseudo-GT
extraction; port of ``avi_talking_tpu/data/preprocess.py``).

The reference's EmocaPreprocessor and the MEAD / FaceVideoDataModule folder
writers: the frozen ``models.emoca.EmocaEncoder`` over a clip's frames in
fixed-size chunks (``data.batching.chunked_apply``), the global rotation
zeroed, the shape code averaged over the clip weighted by landmark
validity, and the ``EMOCA_v2_lr_mse_20/<frame>_000/{exp,pose,shape,
cam}.npy`` layout that ``data.mead.MeadEmocaDataset`` reads, with the
crops (``detections/``), landmarks, validity and photometric masks
(``masks/``) beside it.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from .batching import chunked_apply
from .yuv import rgb_to_yuv420, yuv420_packed_size, yuv420_to_rgb


@dataclasses.dataclass
class EmocaPreprocessor:
    """Frozen-encoder pseudo-GT extractor; the encoder's device is where
    it runs.

    ``transport``: how frames go to the device.
      - "auto":   uint8 frames as uint8 (normalised on the device), float
                  frames as float32;
      - "float":  float32 always;
      - "u8":     uint8 always, float frames rounded to 1/255 steps (the
                  precision of the PNG crops the reference stores);
      - "yuv420": packed planar YUV 4:2:0 uint8 (``data.yuv``), RGB rebuilt
                  on the device.
    Each chunk's codes are packed into one tensor on the device and fetched
    once."""

    encoder: torch.nn.Module  # models.emoca.EmocaEncoder
    max_b: int = 32
    with_global_pose: bool = False
    average_shape_decode: bool = True
    crash_on_invalid: bool = True
    transport: str = "auto"
    inflight: int = 2  # chunk results left unfetched while later chunks run

    def __post_init__(self):
        self.device = next(self.encoder.parameters()).device
        self._spec = None  # [(key, width)], from the first chunk

    @torch.no_grad()
    def _apply(self, x: torch.Tensor, hw=None) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = yuv420_to_rgb(x, *hw) if x.dim() == 2 else x.float() / 255.0
        codes = self.encoder(x.permute(0, 3, 1, 2).contiguous())
        keys = sorted(codes)
        if self._spec is None:
            self._spec = [(k, codes[k].shape[-1]) for k in keys]
        return torch.cat([codes[k].float() for k in keys], dim=-1)

    def _encode(self, send: np.ndarray, hw) -> Dict[str, np.ndarray]:
        packed = chunked_apply(lambda c: self._apply(c, hw), send, self.max_b,
                               inflight=self.inflight, device=self.device)
        out, off = {}, 0
        for key, width in self._spec:
            out[key] = packed[:, off:off + width]
            off += width
        return out

    def encode_frames(self, frames: np.ndarray) -> Dict[str, np.ndarray]:
        """(T, H, W, 3) images in [0, 1] float or uint8 -> per-frame codes."""
        t, h, w = frames.shape[:3]
        transport = self.transport
        if transport == "auto":
            transport = "u8" if frames.dtype == np.uint8 else "float"
        if transport == "float":
            send = frames.astype(np.float32, copy=False)
            if frames.dtype == np.uint8:
                send = send / 255.0
        else:
            u8 = (frames if frames.dtype == np.uint8 else
                  np.clip(np.rint(np.asarray(frames) * 255.0), 0, 255).astype(np.uint8))
            send = rgb_to_yuv420(u8) if transport == "yuv420" else u8
        return self._encode(send, (h, w) if transport == "yuv420" else None)

    def encode_packed_yuv420(self, packed_frames: np.ndarray, height: int,
                             width: int) -> Dict[str, np.ndarray]:
        """Frames already packed as yuv420 rows (T, H*W*3/2) uint8, as
        ``data.videoio.iter_video_yuv420`` streams them: no host pixel work,
        1.5 bytes a pixel to the device."""
        if packed_frames.ndim != 2 or packed_frames.shape[1] != yuv420_packed_size(height, width):
            raise ValueError(f"expected (T, {yuv420_packed_size(height, width)}) packed yuv420 "
                             f"rows for {height}x{width}, got {packed_frames.shape}")
        return self._encode(packed_frames, (height, width))

    def pseudo_gt(self, frames: Optional[np.ndarray] = None,
                  landmark_validity: Optional[np.ndarray] = None,
                  codes: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
        """The reference's EmocaPreprocessor.forward: the global pose zeroed,
        the landmark-validity-weighted mean shape on every frame. ``codes``
        (from ``encode_frames`` / ``encode_packed_yuv420``) skips the
        encoder; then ``frames`` may be None."""
        if codes is None and frames is None:
            raise ValueError("pseudo_gt needs frames or precomputed codes")
        codes = dict(self.encode_frames(frames) if codes is None else codes)
        T = codes["exp"].shape[0]
        if not self.with_global_pose:
            codes["pose"] = codes["pose"].copy()
            codes["pose"][:, :3] = 0.0
        if landmark_validity is None:
            w = np.full((T, 1), 1.0 / T, np.float32)
        else:
            s = landmark_validity.sum()
            if s <= 0 or not np.isfinite(s):
                msg = "landmark validity sums to zero/NaN"
                if self.crash_on_invalid:
                    raise ValueError(msg)
                print(f"[WARNING] {msg}; falling back to uniform weights")
                w = np.full((T, 1), 1.0 / T, np.float32)
            else:
                w = (landmark_validity / s).astype(np.float32)[:, None]
        avg_shape = (w * codes["shape"]).sum(axis=0)
        if self.average_shape_decode:
            codes["shape"] = np.broadcast_to(avg_shape[None], codes["shape"].shape).copy()
        return codes


def landmarks_from_codes(flame, codes: Dict[str, np.ndarray], chunk: int = 32) -> np.ndarray:
    """Pseudo 2D landmarks from the codes: FLAME's 68 points under the
    predicted weak-perspective camera (DECA.decode's landmark path), (T, 68,
    2) in [-1, 1], y down; on the FLAME assets' device, in chunks padded by
    the last frame."""
    from ..core.projection import batch_orth_proj

    dev = flame.assets.v_template.device
    T = codes["exp"].shape[0]
    outs = []
    for i in range(0, T, chunk):
        n = min(chunk, T - i)
        args = []
        for key in ("shape", "exp", "pose", "cam"):
            a = codes[key][i:i + n]
            if n < chunk:
                a = np.concatenate([a, np.repeat(a[-1:], chunk - n, axis=0)])
            args.append(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev))
        shape, exp, pose, cam = args
        with torch.no_grad():
            _, lmk2d, _ = flame(shape[:, :flame.n_shape], exp[:, :flame.n_exp], pose)
            p = batch_orth_proj(lmk2d, cam)[..., :2]
            outs.append(torch.stack([p[..., 0], -p[..., 1]], dim=-1).cpu().numpy()[:n])
    return np.concatenate(outs).astype(np.float32)


def write_emoca_folders(clip_dir: str, codes: Dict[str, np.ndarray], wav_src: Optional[str] = None,
                        detections: Optional[np.ndarray] = None) -> str:
    """The MEAD / EMOCA layout: <clip>/EMOCA_v2_lr_mse_20/<frame>_000/{exp,
    pose,shape,cam}.npy, <clip>/<clip>.wav and detections/<frame>_000.png."""
    from ..viz.pngio import write_png

    frames_dir = os.path.join(clip_dir, "EMOCA_v2_lr_mse_20")
    os.makedirs(frames_dir, exist_ok=True)
    T = codes["exp"].shape[0]
    for t in range(T):
        fd = os.path.join(frames_dir, f"{t:05d}_000")
        os.makedirs(fd, exist_ok=True)
        for key in ("exp", "pose", "shape", "cam"):
            np.save(os.path.join(fd, f"{key}.npy"), codes[key][t])
    if wav_src and os.path.exists(wav_src):
        name = os.path.basename(clip_dir.rstrip("/"))
        dst = os.path.join(clip_dir, name + ".wav")
        if not os.path.exists(dst) or not os.path.samefile(wav_src, dst):
            shutil.copyfile(wav_src, dst)  # the video path demuxes in place
    if detections is not None:
        det_dir = os.path.join(clip_dir, "detections")
        os.makedirs(det_dir, exist_ok=True)
        for t in range(T):
            d = detections[t]
            if d.dtype != np.uint8:
                d = (np.clip(d, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(det_dir, f"{t:05d}_000.png"), d)
    return clip_dir


def _detect_crop_stream(chunks_factory, blk: int, detector, box_detector, crop_size: int,
                        crop_scale: float, crop_smooth_sigma: float,
                        validity: Optional[np.ndarray]):
    """Two streaming passes over full frames (FaceVideoDataModule's detect
    step): the landmark track, then the warp-crops from the (smoothed) box
    track. ``chunks_factory()`` yields (n, (blk, H, W, 3) uint8) chunks, so
    the host holds one chunk of full frames at a time and every device call
    sees one shape. -> (crops (T, S, S, 3) uint8, crop-space landmarks
    (T, 68, 2), validity (T,) or None)."""
    from .facecrop import (bbox2point_kpt68, detect_fullframe_landmarks, landmarks_to_crop_space,
                           smooth_track, warp_crop)

    lmks, scs = [], []
    for n, full in chunks_factory():
        lm, sc = detect_fullframe_landmarks(detector, full, box_detector=box_detector)
        lmks.append(lm[:n])
        scs.append(sc[:n])
    if not lmks:  # an empty source: the clip is skipped
        return None, None, validity
    lmk_px = np.concatenate(lmks)
    det_val = np.clip(np.concatenate(scs).mean(-1), 0.0, None).astype(np.float32)
    old_size, center = bbox2point_kpt68(lmk_px)
    size = (old_size * crop_scale).astype(np.float32)
    if crop_smooth_sigma > 0:
        center, size = smooth_track(center, size, validity=det_val, sigma=crop_smooth_sigma)
    crops, done = [], 0
    for n, full in chunks_factory():
        cb, sb = center[done:done + blk], size[done:done + blk]
        done += n
        if cb.shape[0] < blk:  # a padded tail: the last box repeated
            pad = blk - cb.shape[0]
            cb = np.concatenate([cb, np.repeat(cb[-1:], pad, axis=0)])
            sb = np.concatenate([sb, np.repeat(sb[-1:], pad, axis=0)])
        # rounded to uint8 on the device: the precision of detections/*.png
        crops.append(warp_crop(full, cb, sb, crop_size, out_u8=True, device=detector.device)[:n])
    frames = np.concatenate(crops)
    det_lmk = landmarks_to_crop_space(lmk_px, center, size, crop_size)
    if validity is None:
        s = det_val.sum()
        validity = det_val if np.isfinite(s) and s > 0 else None
    return frames, det_lmk, validity


def _detected_validity(detector, frames):
    """(landmarks, validity or None): FAN's landmarks and the mean score of
    each frame, None where the scores sum to zero or NaN."""
    det_lmk, det_scores = detector(frames)
    validity = np.clip(det_scores.mean(-1), 0.0, None)
    s = validity.sum()
    return det_lmk, (validity if np.isfinite(s) and s > 0 else None)


def preprocess_clip_folder(pre: EmocaPreprocessor, src_dir: str, out_dir: str,
                           write_detections: bool = True, flame=None, detector=None,
                           crop_full_frames: bool = False, crop_size: int = 224,
                           crop_scale: float = 1.25, crop_smooth_sigma: float = 0.0,
                           box_detector=None, parser=None) -> Optional[str]:
    """One folder of PNG frames (+ optional <name>.wav, validity.npy) -> one
    EMOCA-preprocessed clip folder.

    ``detector`` (FAN) detects landmarks and per-frame validity, which
    weights the shape average (a validity.npy in the folder comes first);
    without it and with ``flame`` the landmarks are FLAME's projection of
    the codes. ``crop_full_frames`` treats the PNGs as full video frames:
    detect, warp-crop the kpt68 box to ``crop_size`` at ``crop_scale``,
    then everything runs on the crops. ``parser`` (BiSeNet) writes the
    photometric masks (masks/<frame>_000.png) that train-emoca reads."""
    from ..viz.pngio import read_image_u8

    paths = sorted(glob.glob(os.path.join(src_dir, "*.png")))
    if not paths:
        return None
    validity = None
    vp = os.path.join(src_dir, "validity.npy")
    if os.path.exists(vp):
        validity = np.load(vp).astype(np.float32)
    det_lmk = None
    if crop_full_frames:
        if detector is None:
            raise ValueError("crop_full_frames needs a landmark detector")
        blk = pre.max_b

        def _chunks():  # uint8 to the device: the detectors and the warp normalise there
            for i in range(0, len(paths), blk):
                ps = paths[i:i + blk]
                n = len(ps)
                ps = ps + [ps[-1]] * (blk - n)
                yield n, np.stack([read_image_u8(p) for p in ps])

        frames, det_lmk, validity = _detect_crop_stream(
            _chunks, blk, detector, box_detector, crop_size, crop_scale, crop_smooth_sigma,
            validity)
    else:
        frames = np.stack([read_image_u8(p) for p in paths])
    if not crop_full_frames and detector is not None:
        det_lmk, det_val = _detected_validity(detector, frames)
        if validity is None:
            validity = det_val
    raw = pre.encode_frames(frames)
    name = os.path.basename(src_dir.rstrip("/"))
    wavs = glob.glob(os.path.join(src_dir, "*.wav"))
    return _finalize_clip(pre, frames, raw, validity, det_lmk, os.path.join(out_dir, name),
                          wavs[0] if wavs else None, write_detections, parser, flame)


def _finalize_clip(pre: EmocaPreprocessor, frames: Optional[np.ndarray],
                   raw: Dict[str, np.ndarray], validity: Optional[np.ndarray],
                   det_lmk: Optional[np.ndarray], clip_path: str, wav_src: Optional[str],
                   write_detections: bool, parser, flame) -> str:
    """The shared tail of the folder and video preprocessors: pseudo-GT
    averaging, the folder layout, masks and landmarks."""
    codes = pre.pseudo_gt(frames, validity, codes=raw)
    clip_dir = write_emoca_folders(
        clip_path, codes, wav_src=wav_src,
        detections=frames if (write_detections and frames is not None) else None)
    if parser is not None:
        from ..viz.pngio import write_png

        masks_dir = os.path.join(clip_dir, "masks")
        os.makedirs(masks_dir, exist_ok=True)
        _, mask = parser(frames)
        for t in range(mask.shape[0]):
            write_png(os.path.join(masks_dir, f"{t:05d}_000.png"),
                      (mask[t] * 255).astype(np.uint8))
    if det_lmk is not None:
        np.save(os.path.join(clip_dir, "landmarks.npy"), det_lmk)
        if validity is not None:
            np.save(os.path.join(clip_dir, "validity.npy"), validity)
    elif flame is not None:
        # projected with the un-zeroed global rotation, so the landmarks lie
        # on the face in the (not frontalised) crops
        lmk = landmarks_from_codes(flame, {**codes, "pose": raw["pose"]}, chunk=pre.max_b)
        np.save(os.path.join(clip_dir, "landmarks.npy"), lmk)
    return clip_dir


def preprocess_clip_video(pre: EmocaPreprocessor, video_path: str, out_dir: str,
                          fps: Optional[float] = 25.0, write_detections: bool = True,
                          flame=None, detector=None, crop_full_frames: bool = False,
                          crop_size: int = 224, crop_scale: float = 1.25,
                          crop_smooth_sigma: float = 0.0, box_detector=None, parser=None,
                          extract_audio: bool = True) -> Optional[str]:
    """One video file -> one EMOCA-preprocessed clip folder (the reference's
    skvideo ingestion, FaceVideoDataModule): decoded through an ffmpeg
    rawvideo pipe (``data.videoio``) one ``max_b`` chunk at a time, the
    audio demuxed to a 16 kHz wav. Pre-cropped videos with no detections,
    detector or parser take the frame-free route: packed yuv420p rows from
    the decoder straight to the device. Options as
    ``preprocess_clip_folder``; without ffmpeg it raises
    ``videoio.FfmpegMissingError``."""
    from .videoio import extract_wav, iter_video_yuv420, probe_video
    from .yuv import yuv420_to_rgb_host

    info = probe_video(video_path)
    name = os.path.splitext(os.path.basename(video_path))[0]
    validity = None  # a video has no validity.npy beside it
    det_lmk = None
    blk = pre.max_b

    def _rgb(packed_chunk: np.ndarray) -> np.ndarray:
        rgb = yuv420_to_rgb_host(packed_chunk, info.height, info.width)
        return np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)

    if crop_full_frames:
        if detector is None:
            raise ValueError("crop_full_frames needs a landmark detector")

        def _chunks():  # each pass opens the decoder again: host memory stays one chunk
            for pk in iter_video_yuv420(video_path, fps=fps, chunk=blk, info=info):
                n = pk.shape[0]
                full = _rgb(pk)
                if n < blk:
                    full = np.concatenate([full, np.repeat(full[-1:], blk - n, axis=0)])
                yield n, full

        frames, det_lmk, validity = _detect_crop_stream(
            _chunks, blk, detector, box_detector, crop_size, crop_scale, crop_smooth_sigma,
            validity)
        if frames is None:  # nothing decoded: skipped like an empty folder
            return None
        raw = pre.encode_frames(frames)
    else:
        chunks = list(iter_video_yuv420(video_path, fps=fps, chunk=blk, info=info))
        if not chunks:
            return None
        if write_detections or detector is not None or parser is not None:
            frames = np.concatenate([_rgb(c) for c in chunks])
            if detector is not None:
                det_lmk, validity = _detected_validity(detector, frames)
            raw = pre.encode_frames(frames)
        else:
            frames = None  # frame-free: packed rows straight to the device
            raw = pre.encode_packed_yuv420(np.concatenate(chunks), info.height, info.width)
    clip_path = os.path.join(out_dir, name)
    wav_src = None
    if extract_audio:
        os.makedirs(clip_path, exist_ok=True)
        wav_path = os.path.join(clip_path, name + ".wav")
        if extract_wav(video_path, wav_path):
            wav_src = wav_path
    return _finalize_clip(pre, frames, raw, validity, det_lmk, clip_path, wav_src,
                          write_detections, parser, flame)
