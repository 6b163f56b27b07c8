"""BrainNetwork ("voxel2clip"): CLIP text embedding -> 128-d style space
(port of ``avi_talking_tpu/models/brain.py``). 768 -> 4096
(LayerNorm + GELU + Dropout), 4 residual MLP blocks, -> 128, plus the
projector head 128 -> 2048 -> 2048 -> 128. The LayerNorms use epsilon 1e-6,
the JAX package's (flax's default). Parameter names follow the reference's
state dict (``lin0.0``, ``mlp.{i}.1``, ``projector.8``, ...)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

FLAX_LN_EPS = 1e-6


def _block(d_in: int, d_out: int, dropout: float) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(d_in, d_out), nn.LayerNorm(d_out, eps=FLAX_LN_EPS), nn.GELU(),
        nn.Dropout(dropout))


class BrainNetwork(nn.Module):
    def __init__(self, out_dim: int = 128, in_dim: int = 768, clip_size: int = 128,
                 hidden: int = 4096, n_blocks: int = 4, use_projector: bool = True,
                 dropout_rate: float = 0.5, block_dropout_rate: float = 0.15):
        super().__init__()
        self.clip_size = clip_size
        self.lin0 = _block(in_dim, hidden, dropout_rate)
        self.mlp = nn.ModuleList(
            _block(hidden, hidden, block_dropout_rate) for _ in range(n_blocks))
        self.lin1 = nn.Linear(hidden, out_dim)
        self.projector = None
        if use_projector:
            self.projector = nn.Sequential(
                nn.LayerNorm(clip_size, eps=FLAX_LN_EPS), nn.GELU(),
                nn.Linear(clip_size, 2048),
                nn.LayerNorm(2048, eps=FLAX_LN_EPS), nn.GELU(),
                nn.Linear(2048, 2048),
                nn.LayerNorm(2048, eps=FLAX_LN_EPS), nn.GELU(),
                nn.Linear(2048, clip_size),
            )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = self.lin0(x)
        for block in self.mlp:
            x = block(x) + x
        x = self.lin1(x)
        if self.projector is None:
            return x, None
        return x, self.projector(x.reshape(x.shape[0], -1, self.clip_size))
