"""Ping-pong extension of short driving sequences (port of
``avi_talking_tpu/data/loop_utils.py``, the reference's ``loop_utils.py``):
``calc_loop_idx`` maps a frame index onto a forward / backward bounce over
the source length, ``loopback_frames`` gathers ``frame_num`` frames from a
shorter clip that way. Works on numpy arrays and tensors alike."""

from __future__ import annotations

import numpy as np


def calc_loop_idx(idx, loop_num: int):
    """Bounce index: 0, 1, .., L-1, L-1, .., 1, 0, 0, 1, ... (the reference's
    formula)."""
    idx = np.asarray(idx)
    flag = -1 * ((idx // loop_num % 2) * 2 - 1)
    new_idx = -flag * (flag - 1) // 2 + flag * (idx % loop_num)
    return (new_idx + loop_num) % loop_num


def loopback_frames(frames, frame_num: int):
    """(L, ...) -> (frame_num, ...) by ping-pong indexing along axis 0."""
    idx = calc_loop_idx(np.arange(frame_num), frames.shape[0])
    return frames[idx]
