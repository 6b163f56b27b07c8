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

_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)
_PROJECTIONS = (nn.Linear, nn.Conv1d, nn.ConvTranspose1d, nn.Conv2d, nn.ConvTranspose2d,
                nn.Conv3d)


def _fill(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=generator) * std)


def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``module`` in place:

    * norms (and modules that set ``affine_norm``): weight (or gain ``g``)
      1, bias 0, running stats 0 / 1;
    * Linear / Conv weights (and spectral-norm ``weight_orig``): LeCun normal
      (std ``fan_in ** -0.5``), biases 0;
    * Embedding tables: normal with std 0.02;
    * recurrent layers (``nn.GRU``): each ``weight_*`` LeCun normal over its
      input width, each ``bias_*`` 0;
    * any other parameter (null embeddings, null KV, learned query): normal
      with std 1, or uniform over ``[low, high)`` where the module's
      ``uniform_init`` maps its name to ``(low, high)``.
    """
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, _NORMS) or getattr(mod, "affine_norm", False) or name == "g":
                    p.fill_(1.0 if name in ("weight", "g") else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                elif isinstance(mod, _PROJECTIONS) or name in ("in_proj_weight", "weight_orig"):
                    fan_in = math.prod(p.shape[1:])
                    _fill(p, 1.0 / math.sqrt(fan_in), generator)
                elif isinstance(mod, nn.Embedding):
                    _fill(p, 0.02, generator)
                elif isinstance(mod, nn.RNNBase):
                    if name.startswith("bias"):
                        p.zero_()
                    else:
                        _fill(p, 1.0 / math.sqrt(p.shape[1]), generator)
                elif name in getattr(mod, "uniform_init", {}):
                    low, high = mod.uniform_init[name]
                    p.copy_(torch.rand(p.shape, generator=generator) * (high - low) + low)
                else:
                    _fill(p, 1.0, generator)
            for name, b in mod.named_buffers(recurse=False):
                b.fill_(1 if name == "running_var" else 0)
            if hasattr(mod, "init_own_"):  # tensors with an initial value of their own
                mod.init_own_()
    return module


def random_module(
    factory: Callable[[], M], device: torch.device, generator: torch.Generator
) -> M:
    """Build ``factory()`` on ``device`` with seeded weights, in eval mode."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device)
    return init_module_(module, generator).eval()
