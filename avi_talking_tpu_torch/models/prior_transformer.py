"""DALLE2-style diffusion-prior denoiser (port of
``avi_talking_tpu/models/prior_transformer.py``).

* ``LucidLayerNorm``: gamma-only, biased variance; the "stable" variant
  divides by the row max first;
* attention: input LN, multi-query (single-head K/V), scale, then NeoX
  rotary on the first ``min(32, dim_head)`` channels of q and of the single
  k head, then two learned null KV tokens concatenated in front, then
  l2norm * sqrt(16) cosine similarity; output Linear + LN;
* feed-forward: LN -> Linear(2 * inner) -> GEGLU (exact gelu) -> Linear;
* T5 relative-position bias over (T, T+1);
* tokens ``[brain, time, image + learned_query]``; the prediction is the
  last token; learned null embeddings stand in for both conditions when
  ``cond_scale != 1``.

Parameter names follow the reference's dalle2 state dict
(``causal_transformer.layers.{i}.0.to_q``, ``to_time_embeds.0.1.net.0.0``).

``dtype`` is the compute dtype (``ops.layers``), as in JAX: the projections
run in it, the attention scores and softmax in float32, ``LucidLayerNorm``
in its input's dtype; the residual stream stays float32 because the tokens
concatenate a float32 image embedding, as JAX's promotion makes them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.layers import Linear, SiLU, gelu, scalar, set_compute_dtype
from ..ops.positional import t5_relative_position_bucket


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` semantics over the last axis: x / max(||x||, eps),
    the norm as JAX's ``jnp.linalg.norm`` forms it (squares in x's dtype)."""
    return x / torch.clamp(torch.sqrt((x * x).sum(dim=-1, keepdim=True)), min=eps)


class LucidLayerNorm(nn.Module):
    """Gamma-only LayerNorm with biased variance (dalle2_pytorch.LayerNorm)."""

    def __init__(self, dim: int, stable: bool = False, eps: float = 1e-5):
        super().__init__()
        self.stable, self.eps = stable, eps
        self.g = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stable:
            x = x / x.amax(dim=-1, keepdim=True).detach()
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        # rsqrt in float32, rounded once: torch's bfloat16 rsqrt on the CPU
        # is not correctly rounded (JAX's is)
        inv = torch.rsqrt((var + scalar(self.eps, x.dtype)).float()).to(x.dtype)
        return (x - mean) * inv * self.g.to(x.dtype)


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """dalle2 SinusoidalPosEmb: (B,) -> (B, dim), cat[sin, cos]."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class _SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return sinusoidal_time_embedding(t, self.dim)


class TimeEmbedMLP(nn.Module):
    """dalle2 MLP(dim, dim_out): depth 2, SiLU, expansion 2 on dim_out."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        hidden = 2 * dim_out
        self.net = nn.Sequential(
            nn.Sequential(Linear(dim, hidden), SiLU()),
            nn.Sequential(Linear(hidden, hidden), SiLU()),
            Linear(hidden, dim_out),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class RelPosBias(nn.Module):
    """T5 relative position bias -> (heads, i, j)."""

    def __init__(self, heads: int, num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, i: int, j: int, device) -> torch.Tensor:
        q_pos = torch.arange(i, device=device)[:, None]
        k_pos = torch.arange(j, device=device)[None, :]
        buckets = t5_relative_position_bucket(k_pos - q_pos, self.num_buckets, self.max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)


def _rotary_freqs(seq_len: int, rot_dim: int, device) -> torch.Tensor:
    inv = 1.0 / (10000.0 ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = t[:, None] * inv[None]
    return torch.cat([freqs, freqs], dim=-1)  # (T, rot_dim)


def _apply_rotary(pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """NeoX-style rotary on the first rot_dim channels of x (..., T, d)."""
    rot_dim = pos.shape[-1]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    half = rot_dim // 2
    rotated = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    xr = xr * torch.cos(pos) + rotated * torch.sin(pos)
    return torch.cat([xr, xp], dim=-1)


class PriorAttention(nn.Module):
    """dalle2 Attention: MQA + null KV + cosine-sim + partial rotary."""

    cosine_sim_scale = 16.0

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = LucidLayerNorm(dim)
        self.to_q = Linear(dim, heads * dim_head, bias=False)
        self.to_kv = Linear(dim, 2 * dim_head, bias=False)
        self.null_kv = nn.Parameter(torch.empty(2, dim_head))
        self.to_out = nn.Sequential(Linear(heads * dim_head, dim, bias=False), LucidLayerNorm(dim))

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        h, dh = self.heads, self.dim_head
        x = self.norm(x)
        q = self.to_q(x).reshape(B, T, h, dh).transpose(1, 2)
        q = q * scalar(dh ** -0.5, q.dtype)
        k, v = self.to_kv(x).chunk(2, dim=-1)  # (B, T, dh) single head
        pos = _rotary_freqs(T, min(32, dh), x.device).to(q.dtype)
        q = _apply_rotary(pos, q)
        k = _apply_rotary(pos, k)
        null_kv = self.null_kv.to(k.dtype)
        k = torch.cat([null_kv[0].expand(B, 1, dh), k], dim=1)  # (B, T+1, dh)
        v = torch.cat([null_kv[1].expand(B, 1, dh), v], dim=1)
        q = l2norm(q) * math.sqrt(self.cosine_sim_scale)
        k = l2norm(k) * math.sqrt(self.cosine_sim_scale)
        sim = torch.einsum("bhtd,bsd->bhts", q.float(), k.float())
        if attn_bias is not None:
            sim = sim + attn_bias[None].to(sim.dtype)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bsd->bhtd", attn, v).transpose(1, 2).reshape(B, T, h * dh)
        return self.to_out(out)


class _GEGLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = x.chunk(2, dim=-1)
        return a * gelu(gate)


def prior_feed_forward(dim: int, mult: int = 4) -> nn.Sequential:
    """dalle2 FeedForward: LN -> Linear(2 * inner) -> GEGLU -> Linear(dim);
    the two identities hold the reference's norm / dropout slots so its
    Linear indices (1 and 5) line up."""
    inner = mult * dim
    return nn.Sequential(
        LucidLayerNorm(dim), Linear(dim, 2 * inner, bias=False), _GEGLU(),
        nn.Identity(), nn.Identity(), Linear(inner, dim, bias=False))


class PriorCausalTransformer(nn.Module):
    """FlaggedCausalTransformer (non-causal, as the prior uses it): rel-pos
    bias, residual attention / feed-forward stack, stable LN out, final
    projection."""

    def __init__(self, dim: int, depth: int = 6, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.rel_pos_bias = RelPosBias(heads)
        self.layers = nn.ModuleList(
            nn.ModuleList([PriorAttention(dim, heads, dim_head),
                           prior_feed_forward(dim)])
            for _ in range(depth))
        self.norm = LucidLayerNorm(dim, stable=True)
        self.project_out = Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        attn_bias = self.rel_pos_bias(T, T + 1, x.device)
        for attn, ff in self.layers:
            x = attn(x, attn_bias) + x
            x = ff(x) + x
        return self.project_out(self.norm(x))


class PriorTransformerNetwork(nn.Module):
    """VersatileDiffusionPriorNetwork (learned_query_mode='pos_emb'):
    ``forward(image_embed (B, n, D), t (B,), text_embed (B, D))`` -> x0-hat
    (B, n, D). A drop probability of 1 swaps in the learned null embedding
    (the unconditional pass of classifier-free guidance); one strictly
    between 0 and 1 (training) swaps it in where the keep mask (B, 1, 1) is
    False: ``brain_keep`` / ``image_keep`` when given, else drawn from
    ``generator`` as ``uniform >= p``, the brain's first."""

    def __init__(self, dim: int = 128, num_tokens: int = 1, depth: int = 6, heads: int = 8,
                 dim_head: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_tokens = dim, num_tokens
        self.null_brain_embeds = nn.Parameter(torch.empty(num_tokens, dim))
        self.null_image_embed = nn.Parameter(torch.empty(num_tokens, dim))
        self.learned_query = nn.Parameter(torch.empty(num_tokens, dim))
        self.to_time_embeds = nn.Sequential(
            nn.Sequential(_SinusoidalPosEmb(dim), TimeEmbedMLP(dim, dim)))
        self.causal_transformer = PriorCausalTransformer(dim, depth, heads, dim_head)
        set_compute_dtype(self, dtype)

    def forward(self, image_embed: torch.Tensor, diffusion_timesteps: torch.Tensor,
                text_embed: torch.Tensor, brain_cond_drop_prob: float = 0.0,
                image_cond_drop_prob: float = 0.0, brain_keep: Optional[torch.Tensor] = None,
                image_keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, n = image_embed.shape[0], self.num_tokens
        image_embed = image_embed.reshape(B, -1, self.dim)
        brain_embed = text_embed.reshape(B, -1, self.dim)

        def cond_drop(embed, null, p, keep):
            if p >= 1.0:
                return null[None].expand_as(embed)
            if p <= 0.0:
                return embed
            if keep is None:
                if generator is None:
                    raise ValueError("condition dropout needs keep masks or a generator")
                keep = torch.rand((B, 1, 1), generator=generator, device=generator.device) >= p
            return torch.where(keep.to(embed.device), embed, null[None])

        brain_embed = cond_drop(brain_embed, self.null_brain_embeds, brain_cond_drop_prob,
                                brain_keep)
        image_embed = cond_drop(image_embed, self.null_image_embed, image_cond_drop_prob,
                                image_keep)
        time_embed = self.to_time_embeds(diffusion_timesteps)[:, None]
        image_embed = image_embed + self.learned_query[None]
        tokens = torch.cat([brain_embed, time_embed, image_embed], dim=1)
        return self.causal_transformer(tokens)[:, -n:, :]

    def forward_with_cond_scale(self, image_embed, t, text_embed, cond_scale: float = 1.0):
        logits = self(image_embed, t, text_embed)
        if cond_scale == 1.0:
            return logits
        null_logits = self(image_embed, t, text_embed,
                           brain_cond_drop_prob=1.0, image_cond_drop_prob=1.0)
        return null_logits + (logits - null_logits) * cond_scale
