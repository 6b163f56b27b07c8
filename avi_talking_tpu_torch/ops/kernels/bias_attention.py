"""Biased attention: ``softmax(q . k^T + bias) . v`` per (b, h).

The port of ``avi_talking_tpu/ops/pallas/attention.py::fused_bias_attention``
(the TPU kernel K3). On CUDA tensors ``fused_bias_attention`` launches the
hand-written kernel ``csrc/bias_attention.cu`` (fp32, sm_90a; its header
says what bounds it and how it is laid out; K1 is the same kernel with the
key bias's strides) or raises; on CPU tensors it
runs ``fused_bias_attention_reference``, the plain PyTorch version, which
the tests hold to JAX and the chip check holds the kernel to.

The bias is a (T, S), (H, T, S) or (B, H, T, S) tensor (rank 4 with size-1
dimensions too), broadcast as ``ops/transformer.py::_merge_bias`` does. The
TPU wrapper materialises it to (B, H, T, S); the kernel reads it in place
through four strides, 0 on each broadcast dimension.

``fused_bias_attention`` is differentiable on both devices, with the same
plain recompute backward as K1 (``keybias_attention.attention_backward``);
the JAX kernel has no vjp, and JAX differentiates its unfused path.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from .build import function, launch
from .keybias_attention import HEAD_DIM_MAX, aligned16, attention_backward

# q, k, v, bias, out; B, H, T, S, d; the bias strides (b, h, t, s); the stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
             + [ctypes.c_void_p])

# Kernel launches since the count was last set to 0 (the chip check zeroes
# it before driving a path and reads it after).
launches = 0
_launches_lock = threading.Lock()


def _count_launch() -> None:
    global launches
    with _launches_lock:
        launches += 1


def fused_bias_attention_reference(
    q: torch.Tensor,  # (B, H, T, d), pre-scaled
    k: torch.Tensor,  # (B, H, S, d)
    v: torch.Tensor,  # (B, H, S, d)
    bias: torch.Tensor,  # broadcastable to (B, H, T, S), additive
) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores, the bias broadcast from its own
    shape."""
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) + bias.float()
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", weights, v).to(q.dtype)


def bias_strides(bias: torch.Tensor, B: int, H: int, T: int, S: int) -> Tuple[int, ...]:
    """The (b, h, t, s) element strides through which the kernel reads a
    contiguous ``bias`` broadcast to (B, H, T, S): 0 on each broadcast
    dimension. Raises if the bias does not broadcast."""
    if not 2 <= bias.dim() <= 4:
        raise ValueError(f"bias of rank {bias.dim()}; expected 2, 3 or 4")
    shape = (1,) * (4 - bias.dim()) + tuple(bias.shape)
    strides, step = [], 1
    for size, full in reversed(list(zip(shape, (B, H, T, S)))):
        if size not in (1, full):
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to "
                             f"{(B, H, T, S)}")
        strides.append(step if size == full and full > 1 else 0)
        step *= size
    return tuple(reversed(strides))


def _check_cuda_inputs(q, k, v, bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q/k/v of rank 4")
    B, H, T, d = q.shape
    S = k.shape[2]
    if k.shape != (B, H, S, d) or v.shape != (B, H, S, d):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d % 8 or d > HEAD_DIM_MAX:
        raise ValueError(f"head_dim {d} must be a multiple of 8 and <= {HEAD_DIM_MAX}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _forward(q, k, v, bias) -> torch.Tensor:
    if q.device.type == "cpu":
        return fused_bias_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_bias_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_inputs(q, k, v, bias)
    B, H, T, _ = q.shape
    return _launch(q, k, v, bias, bias_strides(bias, B, H, T, k.shape[2]))


def _launch(q, k, v, bias, strides) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs, reading ``bias`` at the
    (b, h, t, s) element ``strides``."""
    B, H, T, d = q.shape
    S = k.shape[2]
    k, v = aligned16(k), aligned16(v)
    fn = function("bias_attention", "avi_bias_attention_f32", _ARGTYPES)
    out = torch.empty_like(q)
    err = launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), B, H, T, S, d, *strides)
    if err != 0:
        raise RuntimeError(f"fused_bias_attention kernel launch failed: cudaError {err}")
    _count_launch()
    return out


def _reduce_to(ds: torch.Tensor, shape) -> torch.Tensor:
    """Sum a (B, H, T, S) gradient down to a bias of ``shape``."""
    lead = ds.dim() - len(shape)
    g = ds.sum(tuple(range(lead))) if lead else ds
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dims, keepdim=True) if dims else g


class _BiasAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, ds = attention_backward(q, k, v, bias, do)
        dbias = _reduce_to(ds, bias.shape).to(bias.dtype) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias


def fused_bias_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """(B, H, T, d) attention output, differentiable. CPU tensors take the
    plain version; CUDA tensors take the kernel, which raises on what it
    does not take (non-fp32 or non-contiguous inputs, a bias that does not
    broadcast, head_dim not a multiple of 8 or above 128). The gradient of
    ``bias`` is computed only when it requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _BiasAttention.apply(q, k, v, bias)
    return _forward(q, k, v, bias)  # inference: no autograd node to build
