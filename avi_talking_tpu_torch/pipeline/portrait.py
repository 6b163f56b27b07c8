"""PIRender portrait video from motion coefficients (port of
``avi_talking_tpu/pipeline/portrait.py``).

The reference's inference tooling (``inference_flame.py``: a source
portrait and a per-frame window of FLAME motion semantics drive ``net_G``;
``coef_control.py``: sweeps of the rotation / expression semantics). The
sequence's 27-frame windows are gathered at once and rendered in chunks of
``chunk`` frames, the last chunk padded by repeating its last window, one
``FaceGenerator`` forward a chunk on the generator's device.

The descriptor is the training layout (``train/render_loss.py``):
``[exp | rot3 | jaw3 | cam3]``. Images are (H, W, 3) in [-1, 1] on the
host, as the JAX package hands them over; the generator sees NCHW.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.pirender import FaceGenerator

ArrayLike = Union[np.ndarray, torch.Tensor, Sequence[float]]


def build_semantics(exp: ArrayLike, jaw: ArrayLike, rot: Optional[ArrayLike] = None,
                    cam: Optional[ArrayLike] = None) -> torch.Tensor:
    """(T, C) descriptors ``[exp | rot3 | jaw3 | cam3]``. ``rot`` / ``cam``
    may be (T, 3), (3,) or None (zeros: generated speech coefficients carry
    no head pose or camera, so both default to the frontal view)."""
    exp = torch.as_tensor(np.asarray(exp) if not isinstance(exp, torch.Tensor) else exp)
    jaw = torch.as_tensor(np.asarray(jaw) if not isinstance(jaw, torch.Tensor) else jaw)
    T = exp.shape[0]

    def field(x, name):
        if x is None:
            return exp.new_zeros(T, 3)
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                            dtype=exp.dtype, device=exp.device)
        if x.ndim == 1:
            x = x[None].expand(T, 3)
        if tuple(x.shape) != (T, 3):
            raise ValueError(f"{name} must be (3,) or (T,3), got {tuple(x.shape)}")
        return x

    return torch.cat([exp, field(rot, "rot"), jaw.to(exp.dtype), field(cam, "cam")], dim=-1)


def semantic_windows(descr: torch.Tensor, radius: int = 13) -> torch.Tensor:
    """(T, C) -> (T, 2 * radius + 1, C) edge-clamped windows
    (``train.render_loss.obtain_seq_index`` for every frame at once)."""
    T = descr.shape[0]
    offs = torch.arange(-radius, radius + 1, device=descr.device)
    idx = (torch.arange(T, device=descr.device)[:, None] + offs[None, :]).clamp(0, T - 1)
    return descr[idx]


@dataclasses.dataclass
class PortraitRenderer:
    """Chunked whole-sequence ``net_G`` inference: ``render(source, descr)``
    reenacts ``source`` (H, W, 3) in [-1, 1] with the (T, C) descriptors and
    returns ``{"fake": (T, H, W, 3)}`` (and ``"warp"`` with
    ``return_warp``), float32 numpy in [-1, 1]."""

    generator: FaceGenerator
    chunk: int = 32
    radius: int = 13

    @torch.no_grad()
    def render(self, source: ArrayLike, descr: ArrayLike,
               return_warp: bool = False) -> Dict[str, np.ndarray]:
        device = next(self.generator.parameters()).device
        src = torch.as_tensor(np.asarray(source, np.float32)
                              if not isinstance(source, torch.Tensor) else source)
        src = src.to(device, torch.float32).permute(2, 0, 1)
        descr = torch.as_tensor(np.asarray(descr, np.float32)
                                if not isinstance(descr, torch.Tensor) else descr)
        windows = semantic_windows(descr.to(device, torch.float32), self.radius)
        T = windows.shape[0]
        pad = (-T) % self.chunk
        if pad:
            windows = torch.cat([windows, windows[-1:].expand(pad, *windows.shape[1:])])
        src = src[None].expand(self.chunk, *src.shape)
        fake: List[np.ndarray] = []
        warp: List[np.ndarray] = []
        for s in range(0, T + pad, self.chunk):
            out = self.generator(src, windows[s:s + self.chunk].transpose(1, 2))
            fake.append(out["fake_image"].float().permute(0, 2, 3, 1).cpu().numpy())
            if return_warp:
                warp.append(out["warp_image"].float().permute(0, 2, 3, 1).cpu().numpy())
        res = {"fake": np.concatenate(fake)[:T]}
        if return_warp:
            res["warp"] = np.concatenate(warp)[:T]
        return res


def control_schedule(base: ArrayLike, num: int = 10,
                     exp_presets: Optional[Dict[str, np.ndarray]] = None,
                     exp_scale: float = 2.0) -> Tuple[np.ndarray, List[str]]:
    """A semantic sweep (``coef_control.py`` for FLAME): the rotation
    dimensions between +/- presets (pi/10 on x and y, pi/8 on z) and the
    expression dimensions between presets (by default +/- ``exp_scale`` on
    the first three components), ``num`` steps a leg, back to the centre
    between legs. The descriptor has rot at ``[C-9:C-6)`` and exp at
    ``[0:C-9)``. Returns (frames (L, C), leg names)."""
    base = np.asarray(base, np.float32)
    C = base.shape[0]
    n_exp = C - 9

    def rot_preset(axis: int, sign: float) -> np.ndarray:
        v = np.zeros(3, np.float32)
        v[axis] = sign * (math.pi / 8 if axis == 2 else math.pi / 10)
        return v

    legs: List[Tuple[str, slice, np.ndarray]] = []
    rot_sl = slice(n_exp, n_exp + 3)
    center_rot = base[rot_sl].copy()
    for axis, name in enumerate("xyz"):
        for sign, side in ((1.0, "left"), (-1.0, "right")):
            legs.append((f"rotation_{side}_{name}", rot_sl, rot_preset(axis, sign)))
            legs.append((f"rotation_center_{name}_{side}", rot_sl, center_rot))
    exp_sl = slice(0, n_exp)
    center_exp = base[exp_sl].copy()
    if exp_presets is None:
        exp_presets = {}
        for pc in range(min(3, n_exp)):
            v = center_exp.copy()
            v[pc] += exp_scale
            exp_presets[f"expression_pc{pc}"] = v
    for name, target in exp_presets.items():
        legs.append((name, exp_sl, np.asarray(target, np.float32)))
        legs.append((f"expression_center_after_{name}", exp_sl, center_exp))

    frames: List[np.ndarray] = []
    names: List[str] = []
    current = base.copy()
    for name, sl, target in legs:
        start = current[sl].copy()
        for i in range(num):
            t = i / (num - 1) if num > 1 else 1.0
            f = current.copy()
            f[sl] = start + (np.asarray(target) - start) * t
            frames.append(f)
        current = frames[-1].copy()
        names.append(name)
    return np.stack(frames), names


def frames_to_u8(frames: np.ndarray) -> List[np.ndarray]:
    """[-1, 1] float (T, H, W, 3) -> a list of (H, W, 3) uint8 frames."""
    return list(((np.clip(frames, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8))


def write_strip_video(out_path: str, *streams: np.ndarray, fps: int = 25,
                      audio_path: Optional[str] = None) -> str:
    """The streams side by side along the width, written by
    ``viz.visualizer.save_frames_as_video`` (mp4 with ffmpeg, else a PNG
    frame directory); returns the path written."""
    from ..viz.visualizer import save_frames_as_video

    return save_frames_as_video(frames_to_u8(np.concatenate(streams, axis=2)), out_path, fps,
                                audio_path)
