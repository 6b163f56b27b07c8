"""Biased attention: ``softmax(q . k^T + bias) . v`` per (b, h).

The port of ``avi_talking_tpu/ops/pallas/attention.py::fused_bias_attention``
(the TPU kernel K3). On CUDA tensors ``fused_bias_attention`` launches a
hand-written kernel for sm_90a or raises: float32 q, k and v go to
``csrc/bias_attention.cu``, bfloat16 ones (the FaceFormer family at
bfloat16 compute) to ``csrc/keybias_attention_bf16.cu``'s bias entry; K1
is the same two kernels with the key bias's strides, and each source's
header says what bounds it and how it is laid out. On CPU tensors it runs
``fused_bias_attention_reference``, the plain PyTorch version, which the
tests hold to JAX and the chip check holds the kernels to. Both devices
take what K1 takes (``keybias_attention.check_inputs``): any head dim up
to 128, a float32 or bfloat16 bias beside q of either dtype, any B*H.

The bias is a (T, S), (H, T, S) or (B, H, T, S) tensor (rank 4 with size-1
dimensions too), broadcast as ``ops/transformer.py::_merge_bias`` does. The
TPU wrapper materialises it to (B, H, T, S); the kernel reads it in place
through four strides, 0 on each broadcast dimension.

``fused_bias_attention`` is differentiable on both devices, with the same
plain recompute backward as K1 (``keybias_attention.attention_backward``);
the JAX kernel has no vjp, and JAX differentiates its unfused path.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from .keybias_attention import (attention_backward, check_cuda_layout, check_inputs,
                                launch_attention)

# Kernel launches since the count was last set to 0 (the chip check zeroes
# it before driving a path and reads it after): ``launches`` of the float32
# kernel, ``launches_bf16`` of the bfloat16 one.
launches = 0
launches_bf16 = 0
_launches_lock = threading.Lock()


def _count_launch(bf16: bool) -> None:
    global launches, launches_bf16
    with _launches_lock:
        if bf16:
            launches_bf16 += 1
        else:
            launches += 1


def fused_bias_attention_reference(
    q: torch.Tensor,  # (B, H, T, d), pre-scaled
    k: torch.Tensor,  # (B, H, S, d)
    v: torch.Tensor,  # (B, H, S, d)
    bias: torch.Tensor,  # broadcastable to (B, H, T, S), additive
) -> torch.Tensor:
    """Plain PyTorch version, as ``_attn_kernel`` computes at any input
    dtype: fp32 scores from the products of q and k, the bias (broadcast
    from its own shape) read as fp32, the softmax's weights cast to v's
    dtype, P . V accumulated in fp32 and rounded once to q's dtype."""
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) + bias.float()
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", weights.float(), v.float()).to(q.dtype)


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


def _forward(q, k, v, bias) -> torch.Tensor:
    check_inputs(q, k, v, bias, "bias")
    B, H, T, _ = q.shape
    strides = bias_strides(bias, B, H, T, k.shape[2])  # raises if the bias does not broadcast
    if q.device.type == "cpu":
        return fused_bias_attention_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_bias_attention runs on cpu or cuda, not {q.device}")
    check_cuda_layout(q, k, v, bias, "bias")
    return _launch(q, k, v, bias, strides)


def _launch(q, k, v, bias, strides) -> torch.Tensor:
    """Launch the kernel of q's dtype on checked CUDA inputs, reading
    ``bias`` at the (b, h, t, s) element ``strides``, and count it."""
    out = launch_attention(q, k, v, bias, strides, "fused_bias_attention")
    _count_launch(q.dtype == torch.bfloat16)
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
    plain version; CUDA tensors take the kernel of q's dtype. Both raise on
    what the kernels do not take (dtypes other than float32 or bfloat16, q,
    k and v of mixed dtypes, head_dim above 128, a bias that does not
    broadcast), and the kernels on non-contiguous tensors. The gradient of
    ``bias`` is computed only when it requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _BiasAttention.apply(q, k, v, bias)
    return _forward(q, k, v, bias)  # inference: no autograd node to build
