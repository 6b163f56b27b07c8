"""SpecAugment mask indices, on the host (a numpy copy of
``avi_talking_tpu/audio/specaugment.py``, the fairseq / HF
``_compute_mask_indices`` the reference uses): ``mask_prob * T /
mask_length`` span starts (plus a uniform draw, at least ``min_masks``)
sampled without replacement, each grown to ``mask_length`` frames, and the
number of masked frames equalised across the batch. For the same
``np.random.default_rng`` the mask is bit-equal to JAX's; it feeds
``Wav2Vec2Model(..., mask_time_indices=...)``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_mask_indices(
    shape: Tuple[int, int],
    mask_prob: float = 0.05,
    mask_length: int = 10,
    min_masks: int = 2,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(B, T) bool mask."""
    rng = rng or np.random.default_rng()
    bsz, total = shape
    mask = np.zeros((bsz, total), dtype=bool)

    num_mask = int(mask_prob * total / float(mask_length) + rng.random())
    num_mask = max(min_masks, num_mask)

    idc_list = []
    for _ in range(bsz):
        lengths = np.full(num_mask, mask_length)
        min_len = int(lengths.min()) if num_mask else mask_length
        if total - min_len <= num_mask:
            min_len = total - num_mask - 1
        starts = rng.choice(max(total - min_len, 1), num_mask, replace=False)
        idc = np.asarray([s + off for s, length in zip(starts, lengths)
                          for off in range(int(length))])
        idc_list.append(np.unique(idc[idc < total]))

    min_count = min(len(i) for i in idc_list)
    for b, idc in enumerate(idc_list):
        if len(idc) > min_count:
            idc = rng.choice(idc, min_count, replace=False)
        mask[b, idc] = True
    return mask
