"""The optimizers the JAX trainers build with ``optax.adamw(lr)`` and
``optax.adam(lr)``."""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def _foreach(params) -> Optional[bool]:
    """torch's choice, but off when split (DTensor) and whole tensors mix:
    its multi-tensor kernels take one kind only."""
    from torch.distributed.tensor import DTensor

    kinds = {isinstance(p, DTensor) for p in params}
    return False if len(kinds) > 1 else None


def adamw(params: Iterable[torch.Tensor], lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
    every tensor (torch's own default decay is 1e-2), one group."""
    params = list(params)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
                             foreach=_foreach(params))


def adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 (eps_root 0), no weight
    decay, one group."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
