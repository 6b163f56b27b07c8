"""Positional encodings, the FaceFormer attention biases and the T5
relative-position bucket (port of ``avi_talking_tpu/ops/positional.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e9  # finite -inf stand-in: a fully masked row stays a uniform softmax


def alibi_slopes(n_heads: int) -> np.ndarray:
    """ALiBi per-head slopes (Press et al.), built in Python floats and cast
    to float32 as the JAX function does."""

    def pow2_slopes(n: int) -> list[float]:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2_slopes(n_heads), dtype=np.float32)
    closest = 2 ** math.floor(math.log2(n_heads))
    extra = pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return np.asarray(pow2_slopes(closest) + extra, dtype=np.float32)


def faceformer_bias(
    n_heads: int, seq_len: int, period: int, causal: bool = True,
    dtype=torch.float32, device=None,
) -> torch.Tensor:
    """(H, T, T) additive self-attention bias: causal mask plus periodised
    ALiBi, ``bias[h, i, j] = -slope[h] * ((i - j) // period)`` for ``j <= i``
    and ``NEG_INF`` above the diagonal (when ``causal``)."""
    slopes = torch.as_tensor(alibi_slopes(n_heads), dtype=dtype, device=device)
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    dist = torch.where(i >= j, torch.div(i - j, period, rounding_mode="floor"), 0)
    bias = -slopes[:, None, None] * dist[None].to(dtype)
    if causal:
        bias = torch.where((j > i)[None], torch.tensor(NEG_INF, dtype=dtype, device=device), bias)
    return bias


def enc_dec_alignment_bias(
    tgt_len: int, src_len: int, frames_per_step: int = 1, dtype=torch.float32, device=None,
) -> torch.Tensor:
    """(T, S) additive cross-attention bias: target frame ``i`` sees only
    source frames ``[i*k, i*k + k)`` (k=1: the diagonal)."""
    i = torch.arange(tgt_len, device=device)[:, None]
    j = torch.arange(src_len, device=device)[None, :]
    k = frames_per_step
    allowed = (j >= i * k) & (j < i * k + k)
    return torch.where(allowed, torch.tensor(0.0, dtype=dtype, device=device),
                       torch.tensor(NEG_INF, dtype=dtype, device=device))


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
