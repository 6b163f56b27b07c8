"""CLIP text tower (HF ``CLIPTextModel`` layout; port of
``avi_talking_tpu/models/clip_text.py``): token + learned position
embeddings, pre-LN layers with quick_gelu MLPs, a -1e9 causal bias, final
LayerNorm, all LayerNorms at epsilon 1e-5. Returns the last hidden state
(B, T, hidden); the pipeline means it over tokens. Parameter names are HF's
without the ``text_model.`` prefix."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @classmethod
    def tiny(cls) -> "ClipTextConfig":
        return cls(
            vocab_size=99, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=16,
        )


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(name)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inner)
        self.fc2 = nn.Linear(inner, d)


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(d)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(d, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        d, h = c.hidden_size, c.num_heads
        hd = d // h
        B, T = x.shape[:2]
        a = self.self_attn

        def heads(t):
            return t.reshape(B, T, h, hd).transpose(1, 2)

        y = self.layer_norm1(x)
        q = heads(a.q_proj(y) * (hd ** -0.5))
        logits = torch.einsum("bhtd,bhsd->bhts", q, heads(a.k_proj(y))) + causal_bias
        attn = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhts,bhsd->bhtd", attn, heads(a.v_proj(y)))
        x = x + a.out_proj(ctx.transpose(1, 2).reshape(B, T, d))
        y = self.mlp.fc2(_act(c.hidden_act)(self.mlp.fc1(self.layer_norm2(x))))
        return x + y


class _Embeddings(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(ClipEncoderLayer(cfg) for _ in range(cfg.num_layers))


class ClipTextModel(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:  # (B, T) int
        T = input_ids.shape[1]
        e = self.embeddings
        x = e.token_embedding(input_ids) + e.position_embedding.weight[None, :T]
        i = torch.arange(T, device=input_ids.device)
        causal_bias = torch.where(i[None, :] > i[:, None], -1e9, 0.0).to(x.dtype)
        for layer in self.encoder.layers:
            x = layer(x, causal_bias)
        return self.final_layer_norm(x)
