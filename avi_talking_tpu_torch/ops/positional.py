"""Positional encodings and the T5 relative-position bucket (port of the
parts of ``avi_talking_tpu/ops/positional.py`` the generate path uses)."""

from __future__ import annotations

import math

import numpy as np
import torch

def _sinusoid_table(length: int, d_model: int) -> np.ndarray:
    position = np.arange(length, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model)
    )
    table = np.zeros((length, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term[: (d_model + 1) // 2])
    return table.astype(np.float32)


def sinusoidal_positional_encoding(
    length: int, d_model: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Classic (length, d_model) sinusoidal table."""
    return torch.as_tensor(_sinusoid_table(length, d_model), dtype=dtype, device=device)


def periodic_positional_encoding(
    length: int, d_model: int, period: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """The sinusoidal table of one ``period`` tiled along time (FaceFormer's
    periodic positional encoding)."""
    table = _sinusoid_table(period, d_model)
    reps = length // period + 1
    return torch.as_tensor(np.tile(table, (reps, 1))[:length], dtype=dtype, device=device)


def t5_relative_position_bucket(
    relative_position: torch.Tensor,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Causal-style T5 bucketing of ``relative_position = k_pos - q_pos``
    (the prior transformer's RelPosBias: 32 buckets, max distance 128)."""
    n = torch.clamp(-relative_position, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    n_f = torch.clamp(n.to(torch.float32), min=1.0)
    val_if_large = max_exact + (
        torch.log(n_f / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(n.dtype)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return torch.where(is_small, n, val_if_large)
