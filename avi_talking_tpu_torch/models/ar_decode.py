"""KV-cached autoregressive decode for the FaceFormer family (port of
``avi_talking_tpu/models/ar_decode.py``).

A Python loop over the T frames against a preallocated (B, T, H, hd) KV
cache: O(T) new-token work instead of the reference's full-prefix re-decode
per frame. It works on the port's one-layer ``TransformerDecoderLayer``:

* the self-attention projections are always the split slices of the packed
  weight, and the one-query attention (periodised ALiBi and the causal
  mask, computed per step) is plain PyTorch, as in JAX: it launches no K3;
* the diagonal audio alignment mask leaves one key per frame, so the
  cross-attention is the single-key shortcut, context = memory V_i;
* its LayerNorms use epsilon 1e-5, the JAX function's, where the
  teacher-forced decoder uses flax's 1e-6: the AR-vs-teacher-forced
  tolerance absorbs the difference, as in the JAX tests.

It runs at the memory's dtype, as JAX's helpers do: every weight and bias
is cast to it at use, each op's result is rounded to it, and a Python
constant is rounded to it first. Below float32 that differs from the
teacher-forced layers in two places, both JAX's: ``_ln`` takes the mean and
variance at x's dtype (each reduced in float32 and rounded, as
``jnp.mean`` / ``jnp.var`` do) where flax's LayerNorm keeps float32
statistics, and the one-query softmax runs op by op at that dtype
(``jax.nn.softmax``: exp, sum, divide, each rounded).

Inference only: it runs without autograd and writes its cache in place.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import scalar
from ..ops.positional import NEG_INF, alibi_slopes, periodic_positional_encoding
from ..ops.transformer import TransformerDecoderLayer


def _ln(norm: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """JAX's ``_ln``, with ``eps`` (1e-5) already rounded to x's dtype."""
    dt = x.dtype
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    # rsqrt in float32, rounded once: XLA's, where torch's CPU bfloat16 rsqrt
    # rounds some values the other way (rsqrt(17.25): 0.2402 for 0.2412)
    r = torch.rsqrt((var + eps).float()).to(dt)
    return (x - mu) * r * norm.weight.to(dt) + norm.bias.to(dt)


def _split_proj(attn, x: torch.Tensor, part: int) -> torch.Tensor:
    w = attn.in_proj_weight.chunk(3, 0)[part]
    b = attn.in_proj_bias.chunk(3, 0)[part]
    return x @ w.T.to(x.dtype) + b.to(x.dtype)


def _lin(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return x @ lin.weight.T.to(x.dtype) + lin.bias.to(x.dtype)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp((x - x.amax(-1, keepdim=True)).float()).to(x.dtype)  # jax.nn.softmax, op by op
    return e / e.sum(-1, keepdim=True)


@torch.no_grad()
def ar_decode(
    layer: TransformerDecoderLayer,
    memory: torch.Tensor,  # (B, T, D) conditioned audio memory
    token0: torch.Tensor,  # (B, D) first input token (style / obj embedding)
    out_proj: nn.Linear,  # the coeff / vertex head (D -> out_dim)
    feedback_proj: nn.Linear,  # the token map (out_dim -> D)
    n_heads: int,
    period: int,
    style_emb: Optional[torch.Tensor] = None,  # (B, D) added to feedback tokens
    activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
) -> torch.Tensor:
    """Returns (B, T, out_dim) autoregressive outputs."""
    B, T, D = memory.shape
    H = n_heads
    hd = D // H
    dev, dt = memory.device, memory.dtype
    sa, ca = layer.self_attn, layer.multihead_attn

    mem_v = _split_proj(ca, memory, 2).reshape(B, T, H, hd)
    ppe = periodic_positional_encoding(T, D, period, dt, dev)
    slopes = torch.as_tensor(alibi_slopes(H), dtype=dt, device=dev)
    if dt == torch.float32:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    else:  # JAX: 1 / sqrt(asarray(hd, dtype)), each step rounded to dtype
        scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=dt, device=dev))
    j_idx = torch.arange(T, device=dev)
    eps = scalar(1e-5, dt)  # the LayerNorms' epsilon, JAX's, a weak-typed constant

    k_cache = torch.zeros(B, T, H, hd, dtype=dt, device=dev)
    v_cache = torch.zeros_like(k_cache)
    token = token0
    outs = []
    for i in range(T):
        x = token + ppe[i]
        q = _split_proj(sa, x, 0).reshape(B, H, hd)
        k_cache[:, i] = _split_proj(sa, x, 1).reshape(B, H, hd)
        v_cache[:, i] = _split_proj(sa, x, 2).reshape(B, H, hd)
        logits = torch.einsum("bhd,bjhd->bhj", q * scale, k_cache)
        dist = torch.div(torch.clamp(i - j_idx, min=0), period, rounding_mode="floor")
        logits = logits - slopes[None, :, None] * dist[None, None].to(dt)
        logits = torch.where((j_idx > i)[None, None], torch.tensor(NEG_INF, dtype=dt, device=dev),
                             logits)
        attn = _softmax(logits)
        sa_out = torch.einsum("bhj,bjhd->bhd", attn, v_cache).reshape(B, D)
        x = _ln(layer.norm1, x + _lin(sa.out_proj, sa_out), eps)
        # diagonal alignment: one allowed key, weight 1, context = memory V_i
        x = _ln(layer.norm2, x + _lin(ca.out_proj, mem_v[:, i].reshape(B, D)), eps)
        h = _lin(layer.linear2, activation(_lin(layer.linear1, x)))
        x = _ln(layer.norm3, x + h, eps)
        out = _lin(out_proj, x)
        token = _lin(feedback_proj, out)
        if style_emb is not None:
            token = token + style_emb
        outs.append(out)
    return torch.stack(outs, dim=1)
