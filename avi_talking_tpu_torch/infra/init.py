"""Seeded random initialisation of the port's modules.

Modules are built on the ``meta`` device (no storage, no draw from torch's
global generator), moved to their device with ``to_empty`` and filled from
an explicit CPU ``torch.Generator``, so one seed gives the same weights on
any device and no global random state is touched.
"""

from __future__ import annotations

import math
from typing import Callable, TypeVar

import torch
from torch import nn

M = TypeVar("M", bound=nn.Module)

_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d)
_PROJECTIONS = (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)


def _fill(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=generator) * std)


def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``module`` in place:

    * norms: weight (or gain ``g``) 1, bias 0, running stats 0 / 1;
    * Linear / Conv weights: LeCun normal (std ``fan_in ** -0.5``), biases 0;
    * Embedding tables: normal with std 0.02;
    * any other parameter (null embeddings, null KV, learned query): normal
      with std 1.
    """
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, _NORMS) or name == "g":
                    p.fill_(1.0 if name in ("weight", "g") else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                elif isinstance(mod, _PROJECTIONS) or name == "in_proj_weight":
                    fan_in = p.shape[1] * (p.shape[2] if p.dim() == 3 else 1)
                    _fill(p, 1.0 / math.sqrt(fan_in), generator)
                elif isinstance(mod, nn.Embedding):
                    _fill(p, 0.02, generator)
                else:
                    _fill(p, 1.0, generator)
            for name, b in mod.named_buffers(recurse=False):
                b.fill_(1 if name == "running_var" else 0)
    return module


def random_module(
    factory: Callable[[], M], device: torch.device, generator: torch.Generator
) -> M:
    """Build ``factory()`` on ``device`` with seeded weights, in eval mode."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device)
    return init_module_(module, generator).eval()
