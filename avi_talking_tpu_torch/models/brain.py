"""BrainNetwork ("voxel2clip"): CLIP text embedding -> 128-d style space
(port of ``avi_talking_tpu/models/brain.py``). 768 -> 4096
(LayerNorm + GELU + Dropout), 4 residual MLP blocks, -> 128, plus the
projector head 128 -> 2048 -> 2048 -> 128. The LayerNorms use epsilon 1e-6,
the JAX package's (flax's default). Parameter names follow the reference's
state dict (``lin0.0``, ``mlp.{i}.1``, ``projector.8``, ...).

Dropout acts only where the caller passes keep masks (JAX's
``deterministic=False``): one (B, hidden) boolean mask after ``lin0``
(rate 0.5) and one after each block (0.15), kept values scaled by
1 / (1 - rate) as flax does; ``dropout_masks`` draws them from a
``torch.Generator``. Without masks the network is deterministic. ``dtype`` is the compute
dtype (``ops.layers``)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.layers import GELU, LayerNorm, Linear, set_compute_dtype

FLAX_LN_EPS = 1e-6


def _block(d_in: int, d_out: int) -> nn.Sequential:
    """Linear, LayerNorm, GELU; the identity holds the reference's Dropout
    slot (``forward`` applies the masks)."""
    return nn.Sequential(
        Linear(d_in, d_out), LayerNorm(d_out, eps=FLAX_LN_EPS), GELU(), nn.Identity())


class BrainNetwork(nn.Module):
    def __init__(self, out_dim: int = 128, in_dim: int = 768, clip_size: int = 128,
                 hidden: int = 4096, n_blocks: int = 4, use_projector: bool = True,
                 dropout_rate: float = 0.5, block_dropout_rate: float = 0.15,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.clip_size, self.hidden = clip_size, hidden
        self.rates = [dropout_rate] + [block_dropout_rate] * n_blocks
        self.lin0 = _block(in_dim, hidden)
        self.mlp = nn.ModuleList(
            _block(hidden, hidden) for _ in range(n_blocks))
        self.lin1 = Linear(hidden, out_dim)
        self.projector = None
        if use_projector:
            self.projector = nn.Sequential(
                LayerNorm(clip_size, eps=FLAX_LN_EPS), GELU(),
                Linear(clip_size, 2048),
                LayerNorm(2048, eps=FLAX_LN_EPS), GELU(),
                Linear(2048, 2048),
                LayerNorm(2048, eps=FLAX_LN_EPS), GELU(),
                Linear(2048, clip_size),
            )
        set_compute_dtype(self, dtype)

    def dropout_masks(self, batch: int, generator: torch.Generator) -> List[torch.Tensor]:
        """Keep masks for ``forward``: Bernoulli(1 - rate), lin0's first."""
        return [torch.rand((batch, self.hidden), generator=generator, device=generator.device)
                >= rate for rate in self.rates]

    def forward(self, x: torch.Tensor, keep_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        def drop(h, i):
            rate = self.rates[i]
            if keep_masks is None or rate == 0.0:
                return h
            return torch.where(keep_masks[i], h / (1.0 - rate), torch.zeros((), dtype=h.dtype,
                                                                             device=h.device))

        x = drop(self.lin0(x), 0)
        for i, block in enumerate(self.mlp):
            x = drop(block(x), i + 1) + x
        x = self.lin1(x)
        if self.projector is None:
            return x, None
        return x, self.projector(x.reshape(x.shape[0], -1, self.clip_size))
