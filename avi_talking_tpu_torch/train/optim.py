"""The optimizers the JAX trainers build with ``optax.adamw(lr)`` and
``optax.adam(lr)``."""

from __future__ import annotations

from typing import Iterable

import torch


def adamw(params: Iterable[torch.Tensor], lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
    every tensor (torch's own default decay is 1e-2), one group."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 (eps_root 0), no weight
    decay, one group."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
