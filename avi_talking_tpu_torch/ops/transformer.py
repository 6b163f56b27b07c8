"""Post-LN transformer blocks with torch-layout parameters (port of
``avi_talking_tpu/ops/transformer.py``: ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``).

Parameter names are those of ``torch.nn.MultiheadAttention`` /
``TransformerEncoderLayer`` (packed ``in_proj_weight``), so reference state
dicts load as they are. The LayerNorms use epsilon 1e-6, the JAX package's
(flax's default), not torch's 1e-5. Masks are additive float biases
(0 keep, -1e9 drop) broadcastable to (B, H, T, S).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FLAX_LN_EPS = 1e-6


def _merge_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    if bias.dim() == 2:
        return bias[None, None]
    if bias.dim() == 3:
        return bias[None]
    return bias


class MultiHeadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``-compatible attention, batch first."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Self-attention over x (B, T, D) with one packed projection (the
        only use on this path; cross-attention comes with the decoders)."""
        d, h = self.embed_dim, self.num_heads
        hd = d // h
        b, t = x.shape[:2]
        q, k, v = (y.reshape(b, t, h, hd).transpose(1, 2)
                   for y in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
        scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))  # fp32, as the JAX layer
        logits = torch.einsum("bhtd,bhsd->bhts", q * scale, k)
        merged = _merge_bias(bias)
        if merged is not None:
            logits = logits + merged.to(logits.dtype)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhts,bhsd->bhtd", weights, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


def activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.2)
    raise ValueError(f"unknown activation {name!r}")


class TransformerEncoderLayer(nn.Module):
    """Post-LN ``torch.nn.TransformerEncoderLayer`` equivalent, batch first."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", dropout_rate: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.dropout = nn.Dropout(dropout_rate)
        self.activation_name = activation

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.dropout(self.self_attn(x, bias)))
        h = self.dropout(activation(self.activation_name)(self.linear1(x)))
        return self.norm2(x + self.dropout(self.linear2(h)))


class TransformerEncoder(nn.Module):
    """Stack of post-LN encoder layers (``torch.nn.TransformerEncoder``)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, activation: str = "relu",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation, dropout_rate)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, bias)
        return x
