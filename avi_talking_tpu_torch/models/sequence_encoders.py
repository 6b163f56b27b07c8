"""Sequence encoders of the talking head: audio features (B, T, input_dim)
-> (B, T, feature_dim) (port of ``avi_talking_tpu/models/sequence_encoders.py``).

EMOTE's released config uses the linear one; the transformer, GRU and TCN
variants reproduce the reference's ablation configs
(``inferno/models/temporal/SequenceEncoders.py``). flax infers a layer's
input width from its first call; here it is ``input_dim`` (768,
wav2vec2-base's, unless given).

* ``GRUSequenceEncoder`` is ``torch.nn.GRU`` (batch first; the backward
  direction reads the sequence reversed and returns it in order, as flax's
  ``nn.RNN(reverse=True, keep_order=True)``). flax's ``GRUCell`` has the
  gates of ``torch.nn.GRU`` but no recurrent bias on r and z:
  ``infra.jax_params.gru_encoder_state_from_jax`` sets ``b_hr`` and ``b_hz``
  to zero, and only a model trained in torch moves them.
* ``TCNSequenceEncoder`` pads each dilated convolution causally on the left
  by ``(kernel_size - 1) * dilation`` and adds ``gelu(conv)`` as a residual.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import Conv1d, Linear, gelu
from ..ops.positional import sinusoidal_positional_encoding
from ..ops.transformer import TransformerEncoder

WAV2VEC2_BASE_DIM = 768


class LinearSequenceEncoder(nn.Module):
    def __init__(self, feature_dim: int, input_dim: int = WAV2VEC2_BASE_DIM):
        super().__init__()
        self.linear = Linear(input_dim, feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class SimpleTransformerSequenceEncoder(nn.Module):
    """Linear projection, sinusoidal positions (``use_pe``), post-LN encoder
    layers with a feed-forward as wide as the model."""

    def __init__(self, feature_dim: int, input_dim: int = WAV2VEC2_BASE_DIM,
                 num_layers: int = 1, nhead: int = 8, activation: str = "gelu",
                 use_pe: bool = True):
        super().__init__()
        self.feature_dim, self.use_pe = feature_dim, use_pe
        self.in_proj = Linear(input_dim, feature_dim)
        self.encoder = TransformerEncoder(num_layers, feature_dim, nhead, feature_dim, activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_proj(x)
        if self.use_pe:
            x = x + sinusoidal_positional_encoding(x.shape[1], self.feature_dim, x.dtype,
                                                   x.device)[None]
        return self.encoder(x)


class GRUSequenceEncoder(nn.Module):
    """A GRU from zero state; bidirectional: the two directions' halves
    concatenated (each ``feature_dim // 2`` wide)."""

    def __init__(self, feature_dim: int, input_dim: int = WAV2VEC2_BASE_DIM,
                 bidirectional: bool = True):
        super().__init__()
        hidden = feature_dim // 2 if bidirectional else feature_dim
        self.gru = nn.GRU(input_dim, hidden, batch_first=True, bidirectional=bidirectional)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gru(x)[0]


class TCNSequenceEncoder(nn.Module):
    """Linear projection, then ``num_layers`` causal convolutions of
    dilation 1, 2, 4, ..., each a residual ``x + gelu(conv(x))``."""

    def __init__(self, feature_dim: int, input_dim: int = WAV2VEC2_BASE_DIM,
                 num_layers: int = 3, kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.in_proj = Linear(input_dim, feature_dim)
        self.convs = nn.ModuleList(
            Conv1d(feature_dim, feature_dim, kernel_size, dilation=2 ** i)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_proj(x).transpose(1, 2)  # (B, D, T)
        for conv in self.convs:
            h = conv(F.pad(x, ((self.kernel_size - 1) * conv.dilation[0], 0)))
            x = x + gelu(h)
        return x.transpose(1, 2)


def sequence_encoder_from_name(name: str, feature_dim: int, **kw) -> nn.Module:
    """``linear``, ``transformer``, ``gru`` or ``tcn``; ``kw`` go to the
    class (``input_dim``, ``num_layers``, ...)."""
    return {
        "linear": LinearSequenceEncoder,
        "transformer": SimpleTransformerSequenceEncoder,
        "gru": GRUSequenceEncoder,
        "tcn": TCNSequenceEncoder,
    }[name](feature_dim=feature_dim, **kw)
