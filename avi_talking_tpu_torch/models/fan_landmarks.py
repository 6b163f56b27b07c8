"""FAN 2D landmark detector, face_alignment's stacked-hourglass ``2DFAN``
(port of ``avi_talking_tpu/models/fan_landmarks.py``, NCHW).

The reference's preprocessing runs pretrained 2DFAN4 weights on 256^2
crops and decodes 68 landmarks and their confidences from the heatmaps
(``get_preds_fromhm``). Here: the network, the heatmap decode and a
chunked detector that ``preprocess-mead`` drives.

* ``FanHourGlass``: face_alignment's hourglass, average-pool down and
  nearest-neighbour up (PD-FGC's ``models.fan_encoder.HourGlass`` max-pools
  and upsamples bilinearly); the same ``ConvBlock``;
* ``FanLandmarkNet``: stem conv 7x7 / 2 -> ConvBlock(64, 128) -> avg-pool
  -> ConvBlock(128, 128) -> ConvBlock(128, 256), then ``num_modules`` x
  [hourglass -> ConvBlock -> 1x1 conv -> BN -> ReLU -> 1x1 conv to 68
  heatmaps], re-injected between modules through ``bl{i}`` / ``al{i}``;
  returns the last module's (B, 68, S/4, S/4) heatmaps;
* ``decode_heatmaps``: the first maximum, shifted a quarter pixel toward
  the larger interior neighbour (``sign`` of the difference, 0 on a tie),
  plus 0.5, in heatmap pixels;
* ``FanLandmarkDetector``: frames (T, H, W, 3) in [0, 1] or uint8 ->
  landmarks (T, 68, 2) in [-1, 1] (x right, y down) and scores (T, 68),
  resized to ``input_size`` by ``ops.resize.resize_bilinear`` (JAX's
  resize: antialiased when it shrinks).

Parameter names are face_alignment's (``conv1``, ``bn1``, ``conv2-4``,
``m{i}``, ``top_m_{i}``, ``conv_last{i}``, ``bn_end{i}``, ``l{i}``,
``bl{i}``, ``al{i}``), so its state dict loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infra.checkpoint import own_state
from ..ops.resize import resize_bilinear
from .fan_encoder import ConvBlock, HourGlass


class FanHourGlass(HourGlass):
    """face_alignment's hourglass: average-pool down, nearest-neighbour up."""

    def _level(self, x: torch.Tensor, lvl: int) -> torch.Tensor:
        up1 = getattr(self, f"b1_{lvl}")(x)
        low1 = getattr(self, f"b2_{lvl}")(F.avg_pool2d(x, 2, 2))
        low2 = self._level(low1, lvl - 1) if lvl > 1 else self.b2_plus_1(low1)
        low3 = getattr(self, f"b3_{lvl}")(low2)
        return up1 + low3.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = 2 ** self.depth
        if x.shape[2] % k or x.shape[3] % k:
            raise ValueError(f"FanHourGlass(depth={self.depth}) needs spatial dims divisible by "
                             f"{k}, got {tuple(x.shape[2:])}: feed the detector 256 px crops")
        return self._level(x, self.depth)


class FanLandmarkNet(nn.Module):
    """(B, 3, S, S) in [0, 1] -> (B, n_landmarks, S/4, S/4) heatmaps of the
    last module. The defaults are 2DFAN4's."""

    def __init__(self, num_modules: int = 4, depth: int = 4, stem_features: int = 64,
                 features: int = 256, n_landmarks: int = 68):
        super().__init__()
        s, f = stem_features, features
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, s, 7, stride=2, padding=3)
        self.bn1 = nn.BatchNorm2d(s)
        self.conv2 = ConvBlock(s, 2 * s)
        self.conv3 = ConvBlock(2 * s, 2 * s)
        self.conv4 = ConvBlock(2 * s, f)
        for i in range(num_modules):
            self.add_module(f"m{i}", FanHourGlass(depth, f))
            self.add_module(f"top_m_{i}", ConvBlock(f, f))
            self.add_module(f"conv_last{i}", nn.Conv2d(f, f, 1))
            self.add_module(f"bn_end{i}", nn.BatchNorm2d(f))
            self.add_module(f"l{i}", nn.Conv2d(f, n_landmarks, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(f, f, 1))
                self.add_module(f"al{i}", nn.Conv2d(n_landmarks, f, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.conv4(self.conv3(F.avg_pool2d(self.conv2(x), 2, 2)))
        previous, out = x, None
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            if i < self.num_modules - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) + getattr(self, f"al{i}")(out)
        return out


def decode_heatmaps(hm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``get_preds_fromhm`` on (B, H, W, L) heatmaps -> (pts (B, L, 2) x / y
    in heatmap pixels, scores (B, L) peak values)."""
    B, H, W, L = hm.shape
    flat = hm.reshape(B, H * W, L)
    scores = flat.amax(dim=1)
    idx = flat.argmax(dim=1)  # the first maximum
    px, py = idx % W, idx // W

    def peek(dx, dy):
        x = (px + dx).clamp(0, W - 1)
        y = (py + dy).clamp(0, H - 1)
        return flat.gather(1, (y * W + x)[:, None, :])[:, 0, :]

    interior = (px > 0) & (px < W - 1) & (py > 0) & (py < H - 1)
    shift_x = torch.sign(peek(1, 0) - peek(-1, 0)) * 0.25
    shift_y = torch.sign(peek(0, 1) - peek(0, -1)) * 0.25
    fx = px.float() + 0.5 + torch.where(interior, shift_x, 0.0)
    fy = py.float() + 0.5 + torch.where(interior, shift_y, 0.0)
    return torch.stack([fx, fy], dim=-1), scores


def _to_unit_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] or uint8 -> (B, 3, H, W) float32."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    return x.permute(0, 3, 1, 2)


class FanLandmarkDetector:
    """Chunked landmark detection: ``__call__(frames)`` with (T, H, W, 3)
    frames in [0, 1] or uint8, numpy or a tensor on the net's device ->
    (landmarks (T, 68, 2) in [-1, 1], scores (T, 68)), numpy float32.

    ``input_size``: the side the frames are resized to before the net (256
    for 2DFAN4, whose depth-4 hourglass refuses 224); None feeds them as
    they are (the tiny net of the tests)."""

    def __init__(self, model: FanLandmarkNet, max_b: int = 16, input_size: Optional[int] = None):
        self.model = model
        self.max_b = max_b
        self.input_size = input_size
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk on the device -> (landmarks, scores) tensors."""
        x = _to_unit_nchw(x)
        s = self.input_size
        if s and tuple(x.shape[2:]) != (s, s):
            x = resize_bilinear(x, (s, s))
        hm = self.model(x.contiguous()).permute(0, 2, 3, 1)
        pts, scores = decode_heatmaps(hm)
        # normalised by the heatmap's own size: for 256 -> 64 this is the
        # reference's pts * 4 / 256
        size = torch.tensor([hm.shape[2], hm.shape[1]], dtype=torch.float32, device=pts.device)
        return pts / size * 2.0 - 1.0, scores

    def __call__(self, frames) -> Tuple[np.ndarray, np.ndarray]:
        from ..data.batching import chunked_apply

        lmk, sc = chunked_apply(self.forward, frames, self.max_b, device=self.device)
        return lmk.astype(np.float32), sc.astype(np.float32)


def fan_landmarks_state_from_torch(sd: Mapping[str, Any], num_modules: int = 4,
                                   depth: int = 4) -> Dict[str, torch.Tensor]:
    """A face_alignment FAN state dict (bare, or under ``state_dict``) ->
    ``FanLandmarkNet``'s state: its own keys, any other left out."""
    if "state_dict" in sd and not any("conv1" in k for k in sd):
        sd = sd["state_dict"]
    f, s = (int(torch.as_tensor(sd["conv4.conv3.weight"]).shape[0]) * 4,
            int(torch.as_tensor(sd["conv1.weight"]).shape[0]))
    with torch.device("meta"):
        want = FanLandmarkNet(num_modules, depth, s, f)
    return own_state(want, sd)
