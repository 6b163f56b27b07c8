"""Post-LN transformer blocks with torch-layout parameters (port of
``avi_talking_tpu/ops/transformer.py``: ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``,
``TransformerDecoderLayer``, ``TransformerDecoder``).

Parameter names are those of ``torch.nn.MultiheadAttention`` /
``TransformerEncoderLayer`` / ``TransformerDecoderLayer`` (packed
``in_proj_weight``), so reference state dicts load as they are. The
LayerNorms use epsilon 1e-6, the JAX package's (flax's default), not
torch's 1e-5. Masks are additive float biases (0 keep, -1e9 drop)
broadcastable to (B, H, T, S).

``MultiHeadAttention(use_fused_kernel=True)`` sends the scores through
``fused_bias_attention``, the CUDA kernel K3 on the card, with the bias as
it is stored. The JAX flag defaults to off because of a TPU v5e measurement
(XLA's own fusion won at the decoder's shape there), which says nothing of
this card: the port's decoder layers, the FaceFormer family's, set it, as
the port's wav2vec2 runs K1 whatever the JAX ``use_pallas_attention`` gate
says. The encoder layers (EMOTE, FLINT) keep the plain path.

``compute_dtype`` (``ops.layers.set_compute_dtype``) follows flax's
``dtype``. The norms and feed-forward layers cast as ``ops.layers`` does;
the attention's packed projections cast only their weights and biases and
multiply in the promoted type of input and weights, as JAX's
``query @ in_proj_w.T + in_proj_b`` does (EMOTE's decoder gets a float32
input: the float32 style is added to bfloat16 features); the scale is
rounded to the compute dtype, the scores and softmax are float32. The K3
route takes q, k and v at the projections' dtype and the bias as it is
stored (the FaceFormer family's are float32 at either compute dtype): at
bfloat16 it computes what JAX's unfused path does there (float32 scores and
softmax, the weights rounded to bfloat16, P . V of bfloat16 operands
rounded once), which is what the Pallas kernel ``_attn_kernel`` computes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .kernels.bias_attention import fused_bias_attention
from .layers import LayerNorm, Linear, gelu, leaky_relu

FLAX_LN_EPS = 1e-6


def _merge_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    if bias.dim() == 2:
        return bias[None, None]
    if bias.dim() == 3:
        return bias[None]
    return bias


def _promoted_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T + bias`` with weight and bias cast to ``dtype`` and
    the product in the promoted type (JAX's matmul of mixed dtypes)."""
    if x.dtype == dtype == weight.dtype:
        return F.linear(x, weight, bias)
    ct = torch.promote_types(x.dtype, dtype)
    return F.linear(x.to(ct), weight.to(dtype).to(ct)) + bias.to(dtype).to(ct)


class MultiHeadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``-compatible attention, batch first."""

    compute_dtype = torch.float32

    def __init__(self, embed_dim: int, num_heads: int, use_fused_kernel: bool = False):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.use_fused_kernel = use_fused_kernel
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, T, D), key / value (B, S, D). One packed projection when
        all three are the same tensor (self-attention), else the three
        slices of it, as the JAX layer does."""
        d, h, dt = self.embed_dim, self.num_heads, self.compute_dtype
        hd = d // h
        if query is key and key is value:
            q, k, v = _promoted_linear(query, self.in_proj_weight, self.in_proj_bias,
                                       dt).chunk(3, -1)
        else:
            wq, wk, wv = self.in_proj_weight.chunk(3, 0)
            bq, bk, bv = self.in_proj_bias.chunk(3, 0)
            q, k, v = (_promoted_linear(query, wq, bq, dt), _promoted_linear(key, wk, bk, dt),
                       _promoted_linear(value, wv, bv, dt))
        b, t, s = q.shape[0], q.shape[1], k.shape[1]
        q, k, v = (y.reshape(b, -1, h, hd).transpose(1, 2) for y in (q, k, v))
        if dt == torch.float32:
            scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))  # fp32, as the JAX layer
        else:  # JAX: 1 / sqrt(asarray(hd, dtype)), each step rounded to dtype
            scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=dt, device=q.device))
        if self.use_fused_kernel:
            if bias is None:
                bias = torch.zeros(t, s, dtype=q.dtype, device=q.device)
            out = fused_bias_attention((q * scale).contiguous(), k.contiguous(),
                                       v.contiguous(), bias.contiguous())
        else:
            logits = torch.einsum("bhtd,bhsd->bhts", (q * scale).float(), k.float())
            merged = _merge_bias(bias)
            if merged is not None:
                logits = logits + merged.to(logits.dtype)
            weights = torch.softmax(logits, dim=-1).to(dt)
            ct = torch.promote_types(dt, v.dtype)
            out = torch.einsum("bhts,bhsd->bhtd", weights.to(ct), v.to(ct))
        return _promoted_linear(out.transpose(1, 2).reshape(b, t, d), self.out_proj.weight,
                                self.out_proj.bias, dt)


def activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return gelu
    if name == "leaky_relu":
        return lambda x: leaky_relu(x, 0.2)
    raise ValueError(f"unknown activation {name!r}")


class TransformerEncoderLayer(nn.Module):
    """Post-LN ``torch.nn.TransformerEncoderLayer`` equivalent, batch first."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", dropout_rate: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.norm2 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.dropout = nn.Dropout(dropout_rate)
        self.activation_name = activation

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.dropout(self.self_attn(x, x, x, bias)))
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


class TransformerDecoderLayer(nn.Module):
    """Post-LN ``torch.nn.TransformerDecoderLayer`` equivalent, batch first:
    self-attention over the target with ``tgt_bias``, cross-attention to
    ``memory`` with ``memory_bias``, both through K3."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", dropout_rate: float = 0.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, use_fused_kernel=True)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, use_fused_kernel=True)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.norm2 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.norm3 = LayerNorm(d_model, eps=FLAX_LN_EPS)
        self.dropout = nn.Dropout(dropout_rate)
        self.activation_name = activation

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_bias: Optional[torch.Tensor] = None,
                memory_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(tgt + self.dropout(self.self_attn(tgt, tgt, tgt, tgt_bias)))
        x = self.norm2(x + self.dropout(self.multihead_attn(x, memory, memory, memory_bias)))
        h = self.dropout(activation(self.activation_name)(self.linear1(x)))
        return self.norm3(x + self.dropout(self.linear2(h)))


class TransformerDecoder(nn.Module):
    """Stack of post-LN decoder layers (``torch.nn.TransformerDecoder``)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int, activation: str = "relu",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward, activation, dropout_rate)
            for _ in range(num_layers)
        )

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_bias: Optional[torch.Tensor] = None,
                memory_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            tgt = layer(tgt, memory, tgt_bias, memory_bias)
        return tgt
