"""wav2vec2 audio encoder (HF ``Wav2Vec2Model``, post-LN "base" layout) with
the reference's 50 -> 25 fps resampling; port of
``avi_talking_tpu/audio/wav2vec2.py``.

Inside, convolutions run channels first (``Conv1d``); at the module
boundary features are (B, T, D), as in JAX. Parameter names follow the HF
state dict (``feature_extractor.conv_layers.0.conv.weight``,
``encoder.layers.3.attention.q_proj.weight``, ...).

Points kept from the JAX module:

* the per-channel ``GroupNorm(C, C)`` sits on conv layer 0 only, and sees
  the padded length of a bucket-padded batch;
* the resample runs before the feature projection, and ``resample=False``
  skips it whatever the rates;
* ``mask_time_indices`` (SpecAugment, ``audio.specaugment``) replaces the
  masked frames by the learned ``masked_spec_embed`` after the projection
  and before the ``valid_len`` zeroing. JAX creates that parameter only in
  a model initialised with a mask, and the importers drop it as train-only,
  so the port registers it only in a model built with ``mask_time=True``:
  every other state dict loads as it did;
* the positional conv is one ``Conv1d(k=128, groups=16, padding=64)`` with
  the last frame trimmed for the even kernel (the JAX group unrolling only
  works around XLA's partitioner);
* ``valid_len`` zeroes padded features and gives their keys a -1e9 bias;
* q is scaled by ``head_dim ** -0.5`` and attention goes through
  ``keybias_attention`` (the CUDA kernel K1 on the card) in every layer.
  The JAX ``use_pallas_attention`` gate is a TPU measurement and has no
  counterpart here.

``dtype`` is the compute dtype (``ops.layers``, flax's ``dtype``): under
bfloat16 the convolutions, projections and K1's q, k, v and key bias are
bfloat16 (-1e9 rounds to -999,817,216, as JAX's bias cast does), the norms
compute in float32 and return bfloat16. ``wav2vec2_state_from_torch`` reads
an HF ``Wav2Vec2Model`` state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.kernels.keybias_attention import keybias_attention
from ..ops.layers import Conv1d, GroupNorm, LayerNorm, Linear, gelu, scalar, set_compute_dtype
from ..ops.resample import linear_interpolate


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Subset of HF Wav2Vec2Config needed for the base (post-LN) model."""

    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"  # "group" for base, "layer" for large
    do_stable_layer_norm: bool = False

    @classmethod
    def tiny(cls, hidden: int = 32, layers: int = 2, heads: int = 4) -> "Wav2Vec2Config":
        """Small config for tests."""
        return cls(
            conv_dim=(16, 16, 16),
            conv_kernel=(10, 3, 3),
            conv_stride=(5, 2, 2),
            hidden_size=hidden,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            intermediate_size=hidden * 4,
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=2,
        )


_gelu = gelu


class _ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, layer_id: int):
        super().__init__()
        c_in = 1 if layer_id == 0 else cfg.conv_dim[layer_id - 1]
        c_out = cfg.conv_dim[layer_id]
        self.conv = Conv1d(c_in, c_out, cfg.conv_kernel[layer_id],
                              stride=cfg.conv_stride[layer_id], bias=cfg.conv_bias)
        self.norm_kind = None
        if layer_id == 0 and cfg.feat_extract_norm == "group":
            # HF GroupNorm(num_groups=C, num_channels=C): per-channel over time
            self.layer_norm = GroupNorm(c_out, c_out, eps=cfg.layer_norm_eps)
            self.norm_kind = "group"
        elif cfg.feat_extract_norm == "layer":
            self.layer_norm = LayerNorm(c_out, eps=cfg.layer_norm_eps)
            self.norm_kind = "layer"

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, L)
        x = self.conv(x)
        if self.norm_kind == "group":
            x = self.layer_norm(x)
        elif self.norm_kind == "layer":
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        return _gelu(x)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv_layers = nn.ModuleList(_ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:  # (B, samples)
        x = input_values[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)  # (B, frames, conv_dim[-1])


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.trim = k % 2 == 0  # HF Wav2Vec2SamePadLayer drops one for even kernels

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, D)
        h = self.conv(x.transpose(1, 2))
        if self.trim:
            h = h[:, :, :-1]
        return _gelu(h).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)


class _FeedForward(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.intermediate_dense = Linear(d, inner)
        self.output_dense = Linear(inner, d)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (HF Wav2Vec2EncoderLayer, base model)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.attention = _Attention(d)
        self.layer_norm = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(d, cfg.intermediate_size)
        self.final_layer_norm = LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        h = self.heads
        hd = d // h
        a = self.attention

        def heads(t):
            return t.reshape(B, T, h, hd).transpose(1, 2).contiguous()

        q = heads(a.q_proj(x) * scalar(hd ** -0.5, x.dtype))
        ctx = keybias_attention(q, heads(a.k_proj(x)), heads(a.v_proj(x)), key_bias)
        ctx = a.out_proj(ctx.transpose(1, 2).reshape(B, T, d))
        x = self.layer_norm(x + ctx)
        ff = self.feed_forward
        y = ff.output_dense(_gelu(ff.intermediate_dense(x)))
        return self.final_layer_norm(x + y)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x, key_bias)
        return x


class Wav2Vec2Model(nn.Module):
    """Conv extractor -> (resample) -> projection -> (time mask) ->
    transformer.

    ``forward(input_values (B, samples), output_len, valid_len, resample,
    mask_time_indices)`` returns features (B, output_len or native frames,
    hidden_size). ``mask_time=True`` adds the ``masked_spec_embed``
    parameter (drawn from U[0, 1) at a seeded init, as JAX's
    ``uniform(1.0)``) that ``mask_time_indices`` needs.
    """

    def __init__(self, cfg: Wav2Vec2Config, model_expected_fps: int = 50,
                 target_fps: int = 25, dtype: torch.dtype = torch.float32,
                 mask_time: bool = False):
        super().__init__()
        self.cfg = cfg
        self.model_expected_fps = model_expected_fps
        self.target_fps = target_fps
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        if mask_time:
            self.masked_spec_embed = nn.Parameter(torch.empty(cfg.hidden_size))
            self.uniform_init = {"masked_spec_embed": (0.0, 1.0)}
        self.encoder = Encoder(cfg)
        set_compute_dtype(self, dtype)

    def forward(
        self,
        input_values: torch.Tensor,
        output_len: Optional[int] = None,
        valid_len: Optional[torch.Tensor] = None,  # (B,) valid OUTPUT frames
        resample: bool = True,
        mask_time_indices: Optional[torch.Tensor] = None,  # (B, T) bool
    ) -> torch.Tensor:
        """``valid_len`` masks padded tail frames out of self-attention (the
        HF attention_mask path)."""
        x = self.feature_extractor(input_values)
        if resample and (self.model_expected_fps != self.target_fps or output_len is not None):
            if output_len is None:
                output_len = int(x.shape[1] / self.model_expected_fps * self.target_fps)
            x = linear_interpolate(x, output_len, axis=1)
        x = self.feature_projection(x)
        if mask_time_indices is not None:
            if not hasattr(self, "masked_spec_embed"):
                raise ValueError("mask_time_indices needs a model built with mask_time=True")
            embed = self.masked_spec_embed.to(x.dtype)
            x = torch.where(mask_time_indices.to(x.device)[..., None], embed, x)
        B, T = x.shape[:2]
        if valid_len is None:
            key_bias = torch.zeros(B, T, dtype=x.dtype, device=x.device)
        else:
            key_valid = torch.arange(T, device=x.device)[None, :] < valid_len[:, None]
            x = torch.where(key_valid[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
            key_bias = torch.where(key_valid, 0.0, -1e9).to(x.dtype)
        return self.encoder(x, key_bias)


def _pos_conv_weight(sd: Mapping[str, Any], prefix: str) -> torch.Tensor:
    """The positional conv's (O, I/groups, K) weight: as stored, or from
    its weight norm ``w = g * v / ||v||`` over dims (0, 1), under either
    spelling (``weight_g`` / ``weight_v``, or
    ``parametrizations.weight.original0`` / ``original1``), computed in
    numpy float32 as JAX's ``audio/import_hf.py::_pos_conv_kernel`` does."""
    if f"{prefix}weight" in sd:
        return torch.as_tensor(sd[f"{prefix}weight"])
    for gk, vk in ((f"{prefix}weight_g", f"{prefix}weight_v"),
                   (f"{prefix}parametrizations.weight.original0",
                    f"{prefix}parametrizations.weight.original1")):
        if gk in sd:
            g, v = (np.asarray(torch.as_tensor(sd[x]).numpy()) for x in (gk, vk))
            norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
            return torch.from_numpy(np.ascontiguousarray(g * v / norm))
    raise KeyError(f"no pos-conv weight under {prefix!r}")


def wav2vec2_state_from_torch(sd: Mapping[str, Any], cfg: Wav2Vec2Config,
                              prefix: str = "") -> Dict[str, torch.Tensor]:
    """An HF ``Wav2Vec2Model`` state dict -> ``Wav2Vec2Model`` state. The
    names are already the port's (less ``prefix``, e.g. ``wav2vec2.``); the
    positional conv's weight norm is materialised (``_pos_conv_weight``).
    Reads the keys JAX's ``wav2vec2_params_from_torch`` reads: optional conv
    biases and extractor norms where the checkpoint has them; a missing key
    raises ``KeyError``."""
    p = prefix
    out: Dict[str, torch.Tensor] = {}

    def take(name):
        out[name] = torch.as_tensor(sd[p + name])

    for i in range(len(cfg.conv_dim)):
        cl = f"feature_extractor.conv_layers.{i}."
        take(cl + "conv.weight")
        for opt in ("conv.bias", "layer_norm.weight", "layer_norm.bias"):
            if p + cl + opt in sd:
                take(cl + opt)
    for name in ("feature_projection.layer_norm", "feature_projection.projection",
                 "encoder.layer_norm"):
        take(name + ".weight")
        take(name + ".bias")
    out["encoder.pos_conv_embed.conv.weight"] = _pos_conv_weight(
        sd, f"{p}encoder.pos_conv_embed.conv.")
    take("encoder.pos_conv_embed.conv.bias")
    for i in range(cfg.num_hidden_layers):
        lp = f"encoder.layers.{i}."
        for m in ("attention.q_proj", "attention.k_proj", "attention.v_proj",
                  "attention.out_proj", "layer_norm", "feed_forward.intermediate_dense",
                  "feed_forward.output_dense", "final_layer_norm"):
            take(f"{lp}{m}.weight")
            take(f"{lp}{m}.bias")
    return out
