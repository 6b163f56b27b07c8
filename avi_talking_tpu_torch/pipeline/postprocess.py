"""Coefficient post-processing (port of ``avi_talking_tpu/pipeline/postprocess.py``):
silent-interval jaw surgery on device tensors and the host-side
zero-phase Butterworth pose smoothing.

* mouth_opening (s, e): jaw ramps linearly 0 -> jaw[e] over [s, e)
* mouth_closure (s, e): jaw ramps jaw[s] -> 0 over [s, e)
* silent (s, e): jaw zeroed

Expressions are returned untouched; the caller re-decodes FLAME over the
whole modified sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Intervals:
    """Frame intervals (negative indices allowed, resolved against T)."""

    mouth_opening: Sequence[Tuple[int, int]] = ()
    mouth_closure: Sequence[Tuple[int, int]] = ()
    silent: Sequence[Tuple[int, int]] = ()

    @classmethod
    def for_padded_silence(cls, silent_frames_start: int, silent_frames_end: int,
                           num_mouth_frames: int = 5) -> "Intervals":
        """The reference's eval_talking_head_on_audio recipe."""
        opening, closure, silent = [], [], []
        if silent_frames_start > 0:
            silent.append((0, silent_frames_start - num_mouth_frames))
            opening.append((silent_frames_start - num_mouth_frames, silent_frames_start))
        if silent_frames_end > 0:
            silent.append((-silent_frames_end + num_mouth_frames, -1))
            closure.append((-silent_frames_end, -silent_frames_end + num_mouth_frames))
        return cls(tuple(opening), tuple(closure), tuple(silent))


def _resolve(iv: Tuple[int, int], T: int) -> Tuple[int, int]:
    s, e = iv
    return (s + T if s < 0 else s), (e + T if e < 0 else e)


def apply_jaw_intervals(
    exp: torch.Tensor,  # (B, T, n_exp)
    jaw: torch.Tensor,  # (B, T, 3)
    intervals: Intervals,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (exp, modified copy of jaw)."""
    T = jaw.shape[1]
    jaw = jaw.clone()

    def ramp(n):
        return torch.linspace(0.0, 1.0, n, dtype=jaw.dtype, device=jaw.device)[None, :, None]

    for iv in intervals.mouth_opening:
        s, e = _resolve(iv, T)
        if e - s > 0:
            jaw[:, s:e] = ramp(e - s) * jaw[:, e: e + 1]
    for iv in intervals.mouth_closure:
        s, e = _resolve(iv, T)
        if e - s > 0 and s > 0:
            jaw[:, s:e] = jaw[:, s: s + 1] * (1.0 - ramp(e - s))
    for iv in intervals.silent:
        s, e = _resolve(iv, T)
        if e - s > 0:
            jaw[:, s:e] = 0.0
    return exp, jaw


def butter_lowpass_filtfilt(data: np.ndarray, cutoff: float = 4.0, fs: float = 25.0,
                            order: int = 4) -> np.ndarray:
    """Zero-phase Butterworth low-pass along axis 0 (host, scipy)."""
    from scipy.signal import butter, filtfilt

    b, a = butter(order, cutoff / (0.5 * fs), btype="low", analog=False)
    return filtfilt(b, a, data, axis=0).astype(data.dtype)
