"""FLINT motion-prior decoder (port of ``avi_talking_tpu/models/flint.py``).

Latent frames at T / 2^q are upsampled to the frame rate by one
``ConvTranspose1d(k5, s2, p2, output_padding=1)`` and (q-1) x [replicate-
padded ``Conv1d(k5)``, then ``repeat_interleave(2)``], each stage
LeakyReLU(0.2) + BatchNorm normalised by its running statistics (the JAX
``batch_stats``, ``RunningStatsBatchNorm1d``); then a linear embedding, an optional positional
encoding, a post-LN transformer encoder and a ``Conv1d(k5, p2)`` smoothing
layer to exp (n_exp) + jaw (3). Parameter names follow the reference's
``L2lDecoder`` (``expander.{i}.0`` conv, ``expander.{i}.2`` BatchNorm).
``FlintDecoder(cfg, batch_stats=True)`` is the motion prior's own decoder
(``models.flint_vae``): its BatchNorms are ``FlaxBatchNorm1d``, which in
train mode normalise by the batch and update the running statistics.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.layers import Conv1d, ConvTranspose1d, LeakyReLU, Linear
from ..ops.positional import periodic_positional_encoding, sinusoidal_positional_encoding
from ..ops.transformer import TransformerEncoder


@dataclasses.dataclass(frozen=True)
class FlintConfig:
    feature_dim: int = 128
    bottleneck_dim: int = 128
    quant_factor: int = 3  # latent frame size = 2**quant_factor = 8
    num_layers: int = 1
    nhead: int = 8
    intermediate_size: int = 256
    activation: str = "gelu"
    out_dim: int = 53  # exp(50) + jaw(3)
    n_exp: int = 50
    positional_encoding: str = "none"  # none | sinusoidal | periodic
    pe_period: int = 30
    max_seq_len: int = 1200
    post_transformer_proj: bool = False
    post_conv_proj: bool = False

    @property
    def latent_frame_size(self) -> int:
        return 2 ** self.quant_factor


class RunningStatsBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm1d that always normalises with its running statistics, as
    the JAX modules do (``use_running_average=True``), in flax's formula
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``. It is written out,
    not ``F.batch_norm``, so that autograd reaches the statistics when they
    require grad: the JAX training steps hand the whole variables tree,
    ``batch_stats`` included, to optax, and the statistics then train like
    weights (``train.talking_head.emote_trainables``). Under a bfloat16
    ``compute_dtype`` the input is promoted to the statistics' float32 and
    the result rounded back, as flax's BatchNorm does."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C) or (B, C, T)
        def col(t):
            return t.reshape((1, -1) + (1,) * (x.dim() - 2))

        mul = torch.rsqrt(col(self.running_var) + self.eps) * col(self.weight)
        return ((x - col(self.running_mean)) * mul + col(self.bias)).to(self.compute_dtype)


class FlaxBatchNorm1d(RunningStatsBatchNorm1d):
    """flax's ``BatchNorm(momentum=0.9)`` as the motion prior trains it: in
    eval mode the running statistics, as ``RunningStatsBatchNorm1d``; in
    train mode the batch's mean and *biased* variance over every axis but the
    channels (flax's ``mean(x^2) - mean(x)^2``, clipped at 0), with the
    gradient through both, and the running statistics updated outside
    autograd as ``0.9 * running + 0.1 * batch`` (torch's ``F.batch_norm``
    would store the unbiased variance). The statistics stay buffers: the
    optimizer never sees them, as optax sees only JAX's ``params``."""

    momentum_flax = 0.9

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T)
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum_flax
            self.running_mean.mul_(m).add_(mean.detach() * (1 - m))
            self.running_var.mul_(m).add_(var.detach() * (1 - m))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var.reshape(shape) + self.eps) * self.weight.reshape(shape)
        return (x - mean.reshape(shape)) * mul + self.bias.reshape(shape)


class FlintDecoder(nn.Module):
    def __init__(self, cfg: FlintConfig, batch_stats: bool = False):
        super().__init__()
        c = self.cfg = cfg
        f = c.feature_dim
        norm = FlaxBatchNorm1d if batch_stats else RunningStatsBatchNorm1d
        stages = [nn.Sequential(
            ConvTranspose1d(c.bottleneck_dim, f, 5, stride=2, padding=2, output_padding=1),
            LeakyReLU(0.2),
            norm(f, eps=1e-5),
        )]
        for _ in range(1, c.quant_factor):
            stages.append(nn.Sequential(
                Conv1d(f, f, 5, padding=2, padding_mode="replicate"),
                LeakyReLU(0.2),
                norm(f, eps=1e-5),
            ))
        self.expander = nn.ModuleList(stages)
        self.decoder_linear_embedding = Linear(f, f)
        self.decoder_transformer = TransformerEncoder(
            c.num_layers, f, c.nhead, c.intermediate_size, c.activation)
        if c.post_transformer_proj:
            self.post_transformer_linear = Linear(f, f)
        self.cross_smooth_layer = Conv1d(f, c.out_dim, 5, padding=2)
        if c.post_conv_proj:
            self.post_conv_proj = Linear(c.out_dim, c.out_dim)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, T_latent, D) -> (B, T_latent * 2**q, out_dim)."""
        c = self.cfg
        x = self.expander[0](latents.transpose(1, 2))  # (B, F, 2 T_latent)
        for stage in self.expander[1:]:
            x = stage(x).repeat_interleave(2, dim=2)
        x = self.decoder_linear_embedding(x.transpose(1, 2))
        T = x.shape[1]
        if c.positional_encoding == "sinusoidal":
            x = x + sinusoidal_positional_encoding(T, c.feature_dim, x.dtype, x.device)[None]
        elif c.positional_encoding == "periodic":
            x = x + periodic_positional_encoding(
                T, c.feature_dim, c.pe_period, x.dtype, x.device)[None]
        x = self.decoder_transformer(x)
        if c.post_transformer_proj:
            x = self.post_transformer_linear(x)
        x = self.cross_smooth_layer(x.transpose(1, 2)).transpose(1, 2)
        if c.post_conv_proj:
            x = self.post_conv_proj(x)
        return x

    def split_exp_jaw(self, decoded: torch.Tensor):
        return decoded[..., : self.cfg.n_exp], decoded[..., self.cfg.n_exp:]
