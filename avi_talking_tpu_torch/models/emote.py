"""EMOTE-style talking head: audio + 128-d style -> FLAME exp/jaw -> vertices
(port of ``avi_talking_tpu/models/emote.py``).

    raw_audio (B, T, 640) -> flatten -> wav2vec2 (resampled to T) (B, T, 768)
    -> linear sequence encoder (B, T, 128) -> + style (B, 1, 128)
    -> 1-layer transformer encoder -> Linear(128 -> 128) per frame
    -> stack-linear squash: (B, T/8, 8*128) -> (B, T/8, 128) latents
    -> FLINT decoder -> (B, T, 53) -> exp (B, T, 50), jaw (B, T, 3)
    -> FLAME(zero shape, exp, [0, jaw]) over B*T frames -> (B, T, V, 3)

``dtype`` is the compute dtype (``ops.layers``), as JAX's ``dtype``: the
audio enters in it, exp / jaw come out in it, and FLAME runs in float32 on
their values. The float32 style promotes the decoder's input to float32, as
in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..audio.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from ..core.flame import FlameAssets, FlameModel
from ..ops.layers import Conv1d, LeakyReLU, Linear, set_compute_dtype
from ..ops.transformer import TransformerEncoder
from .conditioning import DEFAULT_CONDITION_DIM, EmotionStyleEncoder, StyleCondition
from .flint import FlintConfig, FlintDecoder, RunningStatsBatchNorm1d


class ConvSquasher(nn.Module):
    """(B, T, F) -> (B, T/2^q, out). Stage 0: replicate-padded Conv1d(k5, s2)
    + LeakyReLU(0.2) + BatchNorm1d; stages 1..q-1 the same with stride 1 and
    a MaxPool1d(2). BatchNorm by its running statistics."""

    def __init__(self, in_dim: int, out_dim: int, quant_factor: int):
        super().__init__()
        stages = []
        for i in range(quant_factor):
            layers = [
                Conv1d(in_dim if i == 0 else out_dim, out_dim, 5,
                          stride=2 if i == 0 else 1, padding=2, padding_mode="replicate"),
                LeakyReLU(0.2),
                RunningStatsBatchNorm1d(out_dim, eps=1e-5),
            ]
            if i > 0:
                layers.append(nn.MaxPool1d(2))
            stages.append(nn.Sequential(*layers))
        self.squasher = nn.Sequential(*stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.squasher(x.transpose(1, 2)).transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class EmoteConfig:
    feature_dim: int = 128
    nhead: int = 8
    num_layers: int = 1
    activation: str = "gelu"
    dropout: float = 0.25
    style_op: str = "add"  # add | cat
    squash_type: str = "stack_linear"  # stack_linear | conv
    squash_before: bool = False  # True: squash pre-bert (on feature_dim)
    n_shape: int = 300
    n_exp: int = 50
    flint: FlintConfig = dataclasses.field(default_factory=FlintConfig)
    wav2vec2: Wav2Vec2Config = dataclasses.field(default_factory=Wav2Vec2Config)
    audio_trainable: bool = True

    @classmethod
    def tiny(cls) -> "EmoteConfig":
        """Test-sized config (structure identical, dims shrunk)."""
        return cls(
            feature_dim=32,
            nhead=4,
            flint=FlintConfig(
                feature_dim=32, bottleneck_dim=32, quant_factor=2, nhead=4,
                intermediate_size=64, out_dim=9, n_exp=6,
            ),
            n_shape=8,
            n_exp=6,
            wav2vec2=Wav2Vec2Config.tiny(),
        )


class EmoteTalkingHead(nn.Module):
    """Audio + style -> FLAME coefficient sequences (+ vertices when FLAME
    assets are given; they must lie on the head's device).

    ``condition_dim`` is the width of ``StyleCondition.concat()`` that the
    style encoder takes (flax infers it at init): 343 for 8 expressions and
    300 shape codes, 9 + 3 + 32 + n_shape for ``train-emote``'s batches.
    BatchNorm reads its running statistics in every mode; the decoder's
    dropout (0.25) acts in ``train()`` mode only, so callers that want JAX's
    ``deterministic=True`` (inference and JAX's training step alike) keep the
    head in ``eval()`` mode, as ``random_module`` leaves it."""

    def __init__(self, cfg: EmoteConfig, flame_assets: Optional[FlameAssets] = None,
                 condition_dim: int = DEFAULT_CONDITION_DIM,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.flame_assets = flame_assets
        self.audio_encoder = Wav2Vec2Model(c.wav2vec2)
        self.sequence_encoder = Linear(c.wav2vec2.hidden_size, c.feature_dim)
        self.style_encoder = EmotionStyleEncoder(condition_dim, c.feature_dim)
        d = c.feature_dim * (2 if c.style_op == "cat" else 1)
        self.bert_decoder = (
            TransformerEncoder(c.num_layers, d, c.nhead, d, c.activation, c.dropout)
            if c.num_layers > 0 else None)
        self.decoder = Linear(d, c.flint.bottleneck_dim)
        sq_dim = d if c.squash_before else c.flint.bottleneck_dim
        lfs = c.flint.latent_frame_size
        if c.squash_type == "stack_linear":
            self.squasher = Linear(lfs * sq_dim, sq_dim)
        elif c.squash_type == "conv":
            self.squasher = ConvSquasher(sq_dim, sq_dim, c.flint.quant_factor)
        else:
            raise ValueError(c.squash_type)
        self.motion_prior = FlintDecoder(c.flint)
        self.compute_dtype = dtype
        set_compute_dtype(self, dtype)

    def style_embedding(self, condition: StyleCondition) -> torch.Tensor:
        """(B, 128) style from one-hot conditions."""
        return self.style_encoder(condition.concat().to(self.compute_dtype))

    def _squash(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.squash_type == "conv":
            return self.squasher(x)
        B, T, D = x.shape
        lfs = c.flint.latent_frame_size
        return self.squasher(x.reshape(B, T // lfs, lfs * D))  # row-major stack

    def forward(
        self,
        raw_audio: torch.Tensor,  # (B, T, 640) frames at 25 fps
        style_emb: Optional[torch.Tensor] = None,  # (B, 128) external
        condition: Optional[StyleCondition] = None,
        gt_shape: Optional[torch.Tensor] = None,  # (B, n_shape)
        valid_len: Optional[torch.Tensor] = None,  # (B,) valid frames
    ):
        c = self.cfg
        B, T = raw_audio.shape[:2]
        lfs = c.flint.latent_frame_size
        if T % lfs:
            raise ValueError(
                f"frame count {T} must be a multiple of the FLINT latent frame "
                f"size {lfs}; pad the audio (audio.frontend.frame_audio pad_to_multiple)")
        flat = raw_audio.reshape(B, -1).to(self.compute_dtype)
        feats = self.audio_encoder(flat, output_len=T, valid_len=valid_len)
        if not c.audio_trainable:  # JAX: stop_gradient at the features
            feats = feats.detach()
        hidden = self.sequence_encoder(feats)

        if style_emb is None:
            if condition is None:
                raise ValueError("need condition or style_emb")
            style_emb = self.style_embedding(condition)
        if style_emb.dim() == 2:
            style_emb = style_emb[:, None]
        if c.style_op == "add":
            styled = hidden + style_emb
        elif c.style_op == "cat":
            styled = torch.cat([hidden, style_emb.expand_as(hidden)], dim=-1)
        else:
            raise ValueError(c.style_op)

        if c.squash_before:
            styled = self._squash(styled)
        decoded = self.bert_decoder(styled) if self.bert_decoder is not None else styled
        decoded = self.decoder(decoded)
        latents = decoded if c.squash_before else self._squash(decoded)
        out = self.motion_prior(latents)
        exp, jaw = self.motion_prior.split_exp_jaw(out)

        result = {"exp": exp, "jaw": jaw, "style_emb": style_emb[:, 0]}
        if self.flame_assets is not None:
            flame = FlameModel(self.flame_assets, n_shape=c.n_shape, n_exp=c.n_exp)
            if gt_shape is None:
                gt_shape = exp.new_zeros(B, c.n_shape)
            shape_bt = gt_shape[:, None].expand(B, T, c.n_shape)
            pose = torch.cat([torch.zeros_like(jaw), jaw], dim=-1)
            result["vertices"] = flame.vertices_only(
                shape_bt.reshape(B * T, -1).float(),
                exp.reshape(B * T, -1).float(),
                pose.reshape(B * T, -1).float(),
            ).reshape(B, T, -1, 3)
        return result
