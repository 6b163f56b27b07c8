"""The feed-forward sequence decoders of EMOTE's ablations (port of
``avi_talking_tpu/models/decoders.py``).

The reference's ``FeedForwardDecoder`` family: ``linear``, ``mlp`` (leaky
ReLU 0.01 hidden layers), ``bert`` (post-LN encoder layers, optionally with
FaceFormer's periodic ALiBi bias, ``temporal_bias_type="faceformer"``) and
``flame_bert`` (exp + jaw heads decoded by FLAME into vertices). The style
joins the hidden features by ``add``, ``cat``, ``none`` or ``style_only``.
The head (``decoder``) starts at zero, as JAX's. ``post_bug_fix=False``
keeps the reference's legacy path, where the head reads the styled inputs
and not the encoder's output. EMOTE's default decoder is in
``models.emote``.

flax infers widths from the first call; here a ``cat`` decoder is built
twice as wide as ``feature_dim`` and needs a style at every call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..core.flame import FlameModel
from ..ops.layers import Linear, leaky_relu
from ..ops.positional import faceformer_bias
from ..ops.transformer import TransformerEncoder


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    kind: str = "bert"  # linear | mlp | bert | flame_bert
    feature_dim: int = 128
    vertices_dim: int = 15069
    nhead: int = 8
    num_layers: int = 1
    activation: str = "gelu"
    style_op: str = "add"
    post_bug_fix: bool = True  # False reproduces the reference's legacy path
    temporal_bias_type: str = "none"  # none | faceformer
    period: int = 30
    mlp_hidden_layers: int = 2
    # flame_bert:
    n_exp: int = 50
    predict_jaw: bool = True

    @property
    def out_dim(self) -> int:
        if self.kind == "flame_bert":
            return self.n_exp + (3 if self.predict_jaw else 0)
        return self.vertices_dim


class _ZeroLinear(Linear):
    """A ``Linear`` whose seeded init is all zeros."""

    def init_own_(self) -> None:
        self.weight.zero_()
        self.bias.zero_()


class FeedForwardDecoder(nn.Module):
    """hidden (B, T, D) + style (B, D) or (B, 1, D) -> {"offsets"} (B, T,
    vertices_dim), or for ``flame_bert`` {"exp", "jaw"[, "vertices"]}."""

    def __init__(self, cfg: DecoderConfig, flame_assets=None):
        super().__init__()
        if cfg.kind not in ("linear", "mlp", "bert", "flame_bert"):
            raise ValueError(cfg.kind)
        self.cfg, self.flame_assets = cfg, flame_assets
        d = cfg.feature_dim * (2 if cfg.style_op == "cat" else 1)
        if cfg.kind == "mlp":
            self.mlp = nn.ModuleList(Linear(d, d) for _ in range(cfg.mlp_hidden_layers))
        elif cfg.kind in ("bert", "flame_bert"):
            self.bert_decoder = TransformerEncoder(cfg.num_layers, d, cfg.nhead, d,
                                                   cfg.activation)
        self.decoder = _ZeroLinear(d, cfg.out_dim)

    def _styled(self, hidden: torch.Tensor, style_emb: Optional[torch.Tensor]) -> torch.Tensor:
        op = self.cfg.style_op
        if style_emb is None or op == "none":
            return hidden
        if style_emb.dim() == 2:
            style_emb = style_emb[:, None]
        if op == "add":
            return hidden + style_emb
        if op == "cat":
            return torch.cat([hidden, style_emb.expand(hidden.shape)], dim=-1)
        if op == "style_only":
            return style_emb.expand(hidden.shape)
        raise ValueError(op)

    def forward(self, hidden: torch.Tensor,
                style_emb: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        c = self.cfg
        x = self._styled(hidden, style_emb)
        if c.kind == "linear":
            out = self.decoder(x)
        elif c.kind == "mlp":
            h = x
            for layer in self.mlp:
                h = leaky_relu(layer(h), 0.01)
            out = self.decoder(h)
        else:
            bias = None
            if c.temporal_bias_type == "faceformer":
                bias = faceformer_bias(c.nhead, x.shape[1], c.period, dtype=torch.float32,
                                       device=x.device)
            enc = self.bert_decoder(x, bias)
            out = self.decoder(enc if c.post_bug_fix else x)
        if c.kind != "flame_bert":
            return {"offsets": out}
        exp = out[..., :c.n_exp]
        jaw = out[..., c.n_exp:] if c.predict_jaw else out.new_zeros(out.shape[:-1] + (3,))
        result = {"exp": exp, "jaw": jaw}
        if self.flame_assets is not None:
            B, T = exp.shape[:2]
            n_shape = self.flame_assets.shapedirs.shape[-1] - c.n_exp
            flame = FlameModel(self.flame_assets, n_shape=n_shape, n_exp=c.n_exp)
            pose = torch.cat([torch.zeros_like(jaw), jaw], dim=-1)
            result["vertices"] = flame.vertices_only(
                exp.new_zeros(B * T, n_shape), exp.reshape(B * T, -1),
                pose.reshape(B * T, -1)).reshape(B, T, -1, 3)
        return result
