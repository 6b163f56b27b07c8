"""CLIP text tower (HF ``CLIPTextModel`` layout; port of
``avi_talking_tpu/models/clip_text.py``): token + learned position
embeddings, pre-LN layers with quick_gelu MLPs, a -1e9 causal bias, final
LayerNorm, all LayerNorms at epsilon 1e-5. Returns the last hidden state
(B, T, hidden); the pipeline means it over tokens. Parameter names are HF's
without the ``text_model.`` prefix. ``dtype`` is the compute dtype
(``ops.layers``); the attention scores and softmax stay float32, as in JAX.
``clip_text_state_from_torch`` reads an HF ``CLIPTextModel`` state dict."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch
from torch import nn

from ..ops.layers import (Embedding, LayerNorm, Linear, gelu, scalar, set_compute_dtype,
                          sigmoid)


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
        return lambda x: x * sigmoid(scalar(1.702, x.dtype) * x)
    if name == "gelu":
        return gelu
    raise ValueError(name)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = Linear(d, inner)
        self.fc2 = Linear(inner, d)


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.layer_norm1 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(d)
        self.layer_norm2 = LayerNorm(d, eps=cfg.layer_norm_eps)
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
        q = heads(a.q_proj(y) * scalar(hd ** -0.5, y.dtype))
        v = heads(a.v_proj(y))
        logits = torch.einsum("bhtd,bhsd->bhts", q.float(), heads(a.k_proj(y)).float())
        attn = torch.softmax(logits + causal_bias, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhts,bhsd->bhtd", attn, v)
        x = x + a.out_proj(ctx.transpose(1, 2).reshape(B, T, d))
        y = self.mlp.fc2(_act(c.hidden_act)(self.mlp.fc1(self.layer_norm2(x))))
        return x + y


class _Embeddings(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(ClipEncoderLayer(cfg) for _ in range(cfg.num_layers))


class ClipTextModel(nn.Module):
    def __init__(self, cfg: ClipTextConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        set_compute_dtype(self, dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:  # (B, T) int
        T = input_ids.shape[1]
        e = self.embeddings
        x = e.token_embedding(input_ids)
        x = x + e.position_embedding.weight[None, :T].to(x.dtype)
        i = torch.arange(T, device=input_ids.device)
        causal_bias = torch.where(i[None, :] > i[:, None], -1e9, 0.0)  # float32
        for layer in self.encoder.layers:
            x = layer(x, causal_bias)
        return self.final_layer_norm(x)


def clip_text_state_from_torch(sd: Mapping[str, Any],
                               prefix: str = "text_model.") -> Dict[str, torch.Tensor]:
    """An HF ``CLIPTextModel`` state dict -> ``ClipTextModel`` state: the
    names are HF's less ``prefix``, for the embeddings, every encoder layer
    the checkpoint has and the final LayerNorm (JAX:
    ``models/clip_text.py::clip_text_params_from_torch``, which reads the
    same keys). A missing key raises ``KeyError``; HF's ``position_ids``
    buffer and anything else is not read."""
    names = ["embeddings.token_embedding.weight", "embeddings.position_embedding.weight",
             "final_layer_norm.weight", "final_layer_norm.bias"]
    i = 0
    while f"{prefix}encoder.layers.{i}.layer_norm1.weight" in sd:
        lp = f"encoder.layers.{i}."
        names += [f"{lp}{m}.{w}" for m in ("layer_norm1", "layer_norm2", "self_attn.q_proj",
                                           "self_attn.k_proj", "self_attn.v_proj",
                                           "self_attn.out_proj", "mlp.fc1", "mlp.fc2")
                  for w in ("weight", "bias")]
        i += 1
    return {n: torch.as_tensor(sd[prefix + n]) for n in names}
