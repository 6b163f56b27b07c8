"""Layers with a compute dtype, as flax's ``dtype`` / ``param_dtype``.

The JAX package builds the pipeline's modules with ``dtype`` (the compute
type, bfloat16 under ``--bf16``) and ``param_dtype`` (float32): a Dense or
Conv casts its input, kernel and bias to ``dtype`` at use and adds the bias
after the product is rounded; a norm takes its statistics in float32 and
returns ``dtype``. These subclasses of torch's layers do the same through a
``compute_dtype`` attribute (float32 unless ``set_compute_dtype`` sets it).
Their parameters, and so every state dict and checkpoint, stay float32; at
float32 each computes exactly what its torch base class does (the
BatchNorms in eval mode: they always read their running statistics).

Below float32 the layers and the activations here round where JAX's ops
round when they run one by one: each op's result in the compute dtype, a
Python constant rounded to it first (a weak-typed scalar), the norms' fast
variance ``E[x^2] - E[x]^2`` as flax forms it, GELU as
``0.5 * x * erfc(-x * sqrt(1/2))`` and the sigmoid as ``1 / (1 + exp(-x))``.
torch's fused kernels (``F.gelu``, ``torch.sigmoid``, ``F.silu``) compute
in float32 and round once, which differs in a quarter of the values.

``torch.autocast`` is not used: its op policy (norms, softmax and GELU in
float32 with float32 outputs) is not flax's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set ``compute_dtype`` on every submodule of ``module`` that has one."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


def scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as JAX rounds a weak-typed constant
    before an op on an array of that dtype."""
    return float(torch.tensor(c, dtype=dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU (``jax.nn.gelu(approximate=False)``)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return scalar(0.5, x.dtype) * x * torch.erfc(-x * scalar(0.5 ** 0.5, x.dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) if x.dtype == torch.float32 else x * sigmoid(x)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    if x.dtype == torch.float32:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, scalar(slope, x.dtype) * x)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.log_softmax``: below float32, ``x - max`` less the log of
    its exponentials' sum, each op rounded (the sum accumulates in float32),
    where ``torch.log_softmax`` rounds once."""
    if x.dtype == torch.float32:
        return torch.log_softmax(x, dim)
    shifted = x - x.amax(dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim, keepdim=True))


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class SiLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(x)


class LeakyReLU(nn.Module):
    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.slope)


def _flax_norm(x: torch.Tensor, dims, weight, bias, eps: float, dtype) -> torch.Tensor:
    """flax's normalisation: float32 statistics by the fast variance, then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, cast to ``dtype``.
    ``weight`` / ``bias`` come broadcastable to x."""
    x = x.float()
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return ((x - mean) * (torch.rsqrt(var + eps) * weight) + bias).to(dtype)


def _plain(x: torch.Tensor, layer: nn.Module) -> bool:
    return x.dtype == layer.compute_dtype == layer.weight.dtype


class Linear(nn.Linear):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return super().forward(x)
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv1d(nn.Conv1d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return super().forward(x)
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None]


class Conv2d(nn.Conv2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return super().forward(x)
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class Conv3d(nn.Conv3d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return super().forward(x)
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None, None]


class ConvTranspose1d(nn.ConvTranspose1d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return super().forward(x)
        dt = self.compute_dtype
        y = F.conv_transpose1d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return y if self.bias is None else y + self.bias.to(dt)[:, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return super().forward(x)
        dt = self.compute_dtype
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class LayerNorm(nn.LayerNorm):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return super().forward(x)
        dims = tuple(range(-len(self.normalized_shape), 0))
        return _flax_norm(x, dims, self.weight, self.bias, self.eps, self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return super().forward(x)
        G = self.num_groups
        g = x.reshape(x.shape[0], G, x.shape[1] // G, -1)
        shape = (1, G, x.shape[1] // G, 1)
        return _flax_norm(g, (2, 3), self.weight.reshape(shape), self.bias.reshape(shape),
                          self.eps, self.compute_dtype).reshape(x.shape)


class _RunningBatchNorm:
    """flax's ``BatchNorm(use_running_average=True)`` over channels first:
    the running statistics in every mode. At float32 it is
    ``F.batch_norm`` with them; below, ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias`` with the input promoted to the float32 statistics and
    one rounding to the compute dtype at the end, as flax's ``_normalize``
    computes (``F.batch_norm`` on mixed dtypes rounds elsewhere, and
    differently on the CPU and under cuDNN)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _plain(x, self):
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var.reshape(shape) + self.eps) * self.weight.reshape(shape)
        y = (x - self.running_mean.reshape(shape)) * mul + self.bias.reshape(shape)
        return y.to(self.compute_dtype)


class BatchNorm2d(_RunningBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_RunningBatchNorm, nn.BatchNorm3d):
    pass


class Embedding(nn.Embedding):
    compute_dtype = torch.float32

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)
