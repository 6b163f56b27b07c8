"""FLAME sequence visualisation: vertices -> normal-map video (port of
``FlameVisualizer`` and ``save_frames_as_video`` in
``avi_talking_tpu/viz/visualizer.py``).

Vertex sequences are projected orthographically with a fixed camera and
rendered as normal maps on the visualizer's device (CUDA unless the caller
asks for the CPU), ``frame_chunk`` frames per rasterizer call: on the card
one K2 launch per chunk. Frames go to an mp4 through ffmpeg when it is on
the PATH, else to a directory of PNG frames. ``FixedViewRenderer`` renders
SH-shaded frames from fixed views, differentiably, for the neural losses.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.projection import batch_orth_proj
from ..infra.device import resolve_device
from .pngio import write_png
from .rasterizer import render_normal_maps
from .shading import render_shaded


def save_frames_as_video(
    frames: Sequence[np.ndarray],  # list of (H, W, 3) uint8
    out_path: str,
    fps: int = 25,
    audio_path: Optional[str] = None,
) -> str:
    """mp4 via ffmpeg if present, else a ``<out_path stem>_frames/`` PNG
    directory; returns the path written."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        frame_dir = os.path.splitext(out_path)[0] + "_frames"
        os.makedirs(frame_dir, exist_ok=True)
        for i, fr in enumerate(frames):
            write_png(os.path.join(frame_dir, f"{i:06d}.png"), fr)
        return frame_dir
    with tempfile.TemporaryDirectory() as td:
        for i, fr in enumerate(frames):
            write_png(os.path.join(td, f"{i:06d}.png"), fr)
        cmd = [ffmpeg, "-y", "-framerate", str(fps), "-i", os.path.join(td, "%06d.png")]
        if audio_path and os.path.exists(audio_path):
            cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
        cmd += ["-pix_fmt", "yuv420p", out_path]
        subprocess.run(cmd, check=True, capture_output=True)
    return out_path


class FlameVisualizer:
    """Render (T, V, 3) vertex sequences as normal-map videos.

    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` for the CPU."""

    def __init__(self, faces, image_size: int = 256,
                 camera: Sequence[float] = (8.0, 0.0, -0.01), frame_chunk: int = 16,
                 device=None):
        self.device = resolve_device(device)
        self.faces = torch.as_tensor(faces).to(self.device, torch.long)
        self.image_size = image_size
        self.camera = torch.tensor([list(camera)], dtype=torch.float32, device=self.device)
        self.frame_chunk = frame_chunk

    def project(self, verts: torch.Tensor) -> torch.Tensor:
        """(B, V, 3) model-space vertices -> (B, V, 3) NDC: y flipped to the
        image convention, z negated so depth grows away from the camera
        (DECA convention)."""
        proj = batch_orth_proj(verts, self.camera.expand(verts.shape[0], 3))
        return torch.stack([proj[..., 0], -proj[..., 1], -proj[..., 2]], dim=-1)

    @torch.inference_mode()
    def render_verts(self, verts) -> np.ndarray:
        """(T, V, 3) model-space vertices (numpy or tensor) -> (T, H, W, 3)
        float images in [0, 1]."""
        verts = torch.as_tensor(verts, dtype=torch.float32).to(self.device)
        out = []
        for s in range(0, verts.shape[0], self.frame_chunk):
            imgs = render_normal_maps(self.project(verts[s:s + self.frame_chunk]), self.faces,
                                      self.image_size, self.image_size)
            out.append(imgs.cpu().numpy())
        return np.concatenate(out, axis=0)

    def visualize_verts(self, verts, save_path: str, fps: int = 25,
                        audio_path: Optional[str] = None) -> str:
        imgs = self.render_verts(verts)
        frames = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in imgs]
        return save_frames_as_video(frames, save_path, fps, audio_path)


class FixedViewRenderer:
    """Multi-fixed-view shaded rendering of FLAME vertex sequences (EMOTE's
    FixedViewFlameRenderer): every frame from each fixed camera, and a fixed
    mouth box for the lip-reading loss.

    ``device=None`` means CUDA and raises without a card. Frames go through
    ``rasterize_auto``: K2's route on the card, the plain binned one on the
    CPU, the dense one for meshes under 4096 faces."""

    def __init__(self, faces, image_size: int = 224,
                 cams=((8.0, 0.0, -0.01),), mouth_crop=(0.45, 0.85, 0.25, 0.75),
                 device=None):
        self.device = resolve_device(device)
        self.faces = torch.as_tensor(faces).to(self.device, torch.long)
        self.image_size = image_size
        self.cams = torch.tensor(np.asarray(cams, np.float32), device=self.device)
        self.mouth_crop = mouth_crop

    def project(self, verts: torch.Tensor, view: int = 0) -> torch.Tensor:
        """(T, V, 3) model-space vertices -> (T, V, 3) NDC from camera
        ``view``: y flipped, z negated (depth grows away from the camera)."""
        proj = batch_orth_proj(verts, self.cams[view:view + 1].expand(verts.shape[0], 3))
        return torch.stack([proj[..., 0], -proj[..., 1], -proj[..., 2]], dim=-1)

    def render_torch(self, verts: torch.Tensor, view: int = 0) -> torch.Tensor:
        """(T, V, 3) -> (T, H, W, 3) in [0, 1], differentiable in ``verts``
        (through the shading and the winner's interpolation). All T frames
        go through one rasterizer call: one K2 launch on the card."""
        return render_shaded(self.project(verts, view), self.faces, self.image_size,
                             self.image_size)

    @torch.no_grad()
    def render(self, verts) -> np.ndarray:
        """(T, V, 3) -> (n_views, T, H, W, 3) SH-shaded images."""
        verts = torch.as_tensor(verts, dtype=torch.float32).to(self.device)
        return np.stack([self.render_torch(verts, v).cpu().numpy()
                         for v in range(self.cams.shape[0])])

    def crop_mouth(self, images):
        """(..., H, W, C) -> the fixed mouth box (the lip-reading input crop)."""
        h0, h1, w0, w1 = self.mouth_crop
        H, W = images.shape[-3:-1]
        return images[..., int(h0 * H):int(h1 * H), int(w0 * W):int(w1 * W), :]
