"""Host-side bucketed padding (port of ``pad_to_bucket`` from
``avi_talking_tpu/data/batching.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pad_to_bucket(x: np.ndarray, buckets: Sequence[int], axis: int = 0) -> np.ndarray:
    """Zero-pad ``axis`` up to the smallest bucket >= its length."""
    n = x.shape[axis]
    for b in buckets:
        if n <= b:
            pad = [(0, 0)] * x.ndim
            pad[axis] = (0, b - n)
            return np.pad(x, pad)
    raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")
