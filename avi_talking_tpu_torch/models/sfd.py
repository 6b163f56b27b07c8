"""S3FD single-shot face detector, face_alignment's ``sfd`` backend (port of
``avi_talking_tpu/models/sfd.py``, NCHW).

A VGG16 trunk with L2Norm-rescaled taps and six {conf, loc} SSD heads at
strides 4..128 (anchor side 4x the stride, the max-out background label
on the stride-4 head); the host prior decode and greedy NMS (variances 0.1
/ 0.2, candidates above 0.05, IoU 0.3, then ``threshold``); and the
device top-1 decode ``best_box_device``, which fetches one (n, 5) box a
chunk instead of the score and regression pyramids.

Input is face_alignment's: RGB 0-255 less the mean [104, 117, 123]; the
detector takes [0, 1] floats (scaled by 255) or uint8. Parameter names are
face_alignment's (``conv1_1`` .. ``conv7_2``, ``fc6``, ``fc7``,
``conv{3,4,5}_3_norm``, ``*_mbox_conf`` / ``*_mbox_loc``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infra.checkpoint import own_state


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learned per-channel scale."""

    def __init__(self, n_channels: int, scale_init: float = 1.0):
        super().__init__()
        self.scale_init = scale_init
        self.weight = nn.Parameter(torch.full((n_channels,), scale_init))

    def init_own_(self) -> None:
        self.weight.fill_(self.scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt((x * x).sum(dim=1, keepdim=True)) + 1e-10
        return x / norm * self.weight[:, None, None]


_TRUNK = (  # name, in, out, kernel, stride, padding; "pool" = 2x2 max-pool
    ("conv1_1", 3, 64, 3, 1, 1), ("conv1_2", 64, 64, 3, 1, 1), "pool",
    ("conv2_1", 64, 128, 3, 1, 1), ("conv2_2", 128, 128, 3, 1, 1), "pool",
    ("conv3_1", 128, 256, 3, 1, 1), ("conv3_2", 256, 256, 3, 1, 1),
    ("conv3_3", 256, 256, 3, 1, 1), "pool",
    ("conv4_1", 256, 512, 3, 1, 1), ("conv4_2", 512, 512, 3, 1, 1),
    ("conv4_3", 512, 512, 3, 1, 1), "pool",
    ("conv5_1", 512, 512, 3, 1, 1), ("conv5_2", 512, 512, 3, 1, 1),
    ("conv5_3", 512, 512, 3, 1, 1), "pool",
    ("fc6", 512, 1024, 3, 1, 3), ("fc7", 1024, 1024, 1, 1, 0),
    ("conv6_1", 1024, 256, 1, 1, 0), ("conv6_2", 256, 512, 3, 2, 1),
    ("conv7_1", 512, 128, 1, 1, 0), ("conv7_2", 128, 256, 3, 2, 1),
)
_TAPS = ("conv3_3", "conv4_3", "conv5_3", "fc7", "conv6_2", "conv7_2")
_HEADS = (("conv3_3_norm", 256, 4), ("conv4_3_norm", 512, 2), ("conv5_3_norm", 512, 2),
          ("fc7", 1024, 2), ("conv6_2", 512, 2), ("conv7_2", 256, 2))


class S3FD(nn.Module):
    """(B, 3, H, W) preprocessed -> [cls1, reg1, ..., cls6, reg6] NCHW maps,
    softmax over the class channels, the max-out background folded into
    cls1."""

    def __init__(self):
        super().__init__()
        for layer in _TRUNK:
            if layer != "pool":
                name, cin, cout, k, s, p = layer
                self.add_module(name, nn.Conv2d(cin, cout, k, stride=s, padding=p))
        self.conv3_3_norm = L2Norm(256, 10.0)
        self.conv4_3_norm = L2Norm(512, 8.0)
        self.conv5_3_norm = L2Norm(512, 5.0)
        for tap, ch, n_cls in _HEADS:
            self.add_module(f"{tap}_mbox_conf", nn.Conv2d(ch, n_cls, 3, padding=1))
            self.add_module(f"{tap}_mbox_loc", nn.Conv2d(ch, 4, 3, padding=1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = {}
        for layer in _TRUNK:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, layer[0])(x))
            if layer[0] in _TAPS:
                taps[layer[0]] = x
        for name in ("conv3_3", "conv4_3", "conv5_3"):
            taps[name] = getattr(self, name + "_norm")(taps[name])
        out = []
        for (head, _, _), tap in zip(_HEADS, _TAPS):
            c = getattr(self, f"{head}_mbox_conf")(taps[tap])
            if head == "conv3_3_norm":  # bg = the max of the first three, face the fourth
                c = torch.cat([c[:, :3].amax(dim=1, keepdim=True), c[:, 3:]], dim=1)
            out += [torch.softmax(c, dim=1), getattr(self, f"{head}_mbox_loc")(taps[tap])]
        return out


def decode_priors(loc: np.ndarray, priors: np.ndarray, variances=(0.1, 0.2)) -> np.ndarray:
    """SSD prior decode (face_alignment ``bbox.decode``): centre offset and
    log-size regression -> [x0, y0, x1, y1]."""
    boxes = np.concatenate(
        [priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:],
         priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])], axis=1)
    boxes[:, :2] -= boxes[:, 2:] / 2
    boxes[:, 2:] += boxes[:, :2]
    return boxes


def nms(dets: np.ndarray, thresh: float = 0.3) -> List[int]:
    """Greedy IoU NMS over (N, 5) [x0, y0, x1, y1, score]."""
    if len(dets) == 0:
        return []
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return keep


def _fallback(per_frame, T: int, H: int, W: int) -> np.ndarray:
    """(T, 5) boxes: each frame's, else the previous frame's, else the whole
    frame at zero confidence (``per_frame(t)`` -> a box or None)."""
    out = np.zeros((T, 5), np.float32)
    prev = None
    for t in range(T):
        box = per_frame(t)
        if box is not None:
            prev = box
        out[t] = [0.0, 0.0, W - 1.0, H - 1.0, 0.0] if prev is None else prev
    return out


class SfdDetector:
    """Face boxes over frame batches. ``__call__`` takes (T, H, W, 3)
    frames in [0, 1] (or uint8) and returns a list of (N_t, 5) [x0, y0,
    x1, y1, score] arrays in pixels, NMS'd and filtered at ``threshold``.
    ``best_box`` keeps the top face of each frame (T, 5), the previous
    frame's box where a frame has none; ``best_box_device`` is the same
    with the top-1 decode on the device."""

    MEAN = np.array([104.0, 117.0, 123.0], np.float32)

    def __init__(self, model: S3FD, threshold: float = 0.5, nms_iou: float = 0.3,
                 candidate_floor: float = 0.05, max_b: int = 4):
        self.model = model
        self.threshold = threshold
        self.nms_iou = nms_iou
        self.candidate_floor = candidate_floor
        self.max_b = max_b  # VGG16 at full-frame size holds large activations
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def _maps(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.float() if x.dtype == torch.uint8 else x * 255.0
        x = x - torch.from_numpy(self.MEAN).to(x.device)
        return self.model(x.permute(0, 3, 1, 2).contiguous())

    @torch.no_grad()
    def best(self, x: torch.Tensor) -> torch.Tensor:
        """One chunk -> (B, 5) [box, score] of the highest-scoring anchor
        over the six scales, prior-decoded on the device (greedy NMS always
        keeps the top detection, so this is the host path's top 1)."""
        maps = self._maps(x)
        B = x.shape[0]
        best_score = torch.full((B,), -float("inf"), device=x.device)
        best_box = torch.zeros(B, 4, device=x.device)
        for i in range(len(maps) // 2):
            ocls, oreg = maps[2 * i], maps[2 * i + 1]  # (B, 2, h, w), (B, 4, h, w)
            stride = float(2 ** (i + 2))
            w = ocls.shape[3]
            score = ocls[:, 1].reshape(B, -1)
            idx = score.argmax(dim=1)
            sc = score.gather(1, idx[:, None])[:, 0]
            ws, hs = (idx % w).float(), (idx // w).float()
            loc = oreg.reshape(B, 4, -1).gather(2, idx[:, None, None].expand(B, 4, 1))[..., 0]
            cx = stride / 2 + ws * stride + loc[:, 0] * 0.1 * 4 * stride
            cy = stride / 2 + hs * stride + loc[:, 1] * 0.1 * 4 * stride
            bw = 4 * stride * torch.exp(loc[:, 2] * 0.2)
            bh = 4 * stride * torch.exp(loc[:, 3] * 0.2)
            box = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=1)
            better = sc > best_score
            best_score = torch.where(better, sc, best_score)
            best_box = torch.where(better[:, None], box, best_box)
        return torch.cat([best_box, best_score[:, None]], dim=1)

    def __call__(self, frames) -> List[np.ndarray]:
        from ..data.batching import chunked_apply

        olist = chunked_apply(
            lambda c: tuple(m.permute(0, 2, 3, 1) for m in self._maps(c)), frames, self.max_b,
            device=self.device)  # NHWC numpy maps
        results = []
        for t in range(frames.shape[0]):
            cand = []
            for i in range(len(olist) // 2):
                ocls, oreg = olist[i * 2][t], olist[i * 2 + 1][t]
                stride = 2 ** (i + 2)
                hs, ws = np.where(ocls[..., 1] > self.candidate_floor)
                if hs.size == 0:
                    continue
                axc = stride / 2 + ws * stride
                ayc = stride / 2 + hs * stride
                priors = np.stack([axc, ayc, np.full_like(axc, 4 * stride),
                                   np.full_like(axc, 4 * stride)], axis=1).astype(np.float32)
                boxes = decode_priors(oreg[hs, ws, :], priors)
                cand.append(np.concatenate([boxes, ocls[hs, ws, 1][:, None]], axis=1))
            if cand:
                dets = np.concatenate(cand)
                dets = dets[nms(dets, self.nms_iou)]
                dets = dets[dets[:, 4] >= self.threshold]
            else:
                dets = np.zeros((0, 5), np.float32)
            results.append(dets.astype(np.float32))
        return results

    def best_box(self, frames) -> np.ndarray:
        dets = self(frames)
        H, W = frames.shape[1:3]
        return _fallback(lambda t: dets[t][np.argmax(dets[t][:, 4])] if len(dets[t]) else None,
                         frames.shape[0], H, W)

    def best_box_device(self, frames) -> np.ndarray:
        """``best_box`` with the decode on the device: ``frames`` numpy or a
        tensor on the card; per chunk one (n, 5) tensor is fetched, and the
        previous-frame fallback runs on the host."""
        from ..data.batching import chunked_apply

        bs = chunked_apply(self.best, frames, self.max_b, device=self.device)
        H, W = frames.shape[1:3]
        return _fallback(lambda t: bs[t] if bs[t, 4] >= self.threshold else None,
                         frames.shape[0], H, W)


def sfd_state_from_torch(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A face_alignment s3fd state dict (bare, or under ``state_dict``) ->
    ``S3FD``'s state."""
    if "state_dict" in sd and not any(k.startswith("conv1_1") for k in sd):
        sd = sd["state_dict"]
    with torch.device("meta"):
        want = S3FD()
    return own_state(want, sd)
