"""Key-bias attention: ``softmax(q . k^T + key_bias[b]) . v`` per (b, h).

The port of ``avi_talking_tpu/ops/pallas/attention.py::fused_keybias_attention``
(the TPU kernel K1). On CUDA tensors ``keybias_attention`` launches the
hand-written kernel ``csrc/bias_attention.cu`` through its key-bias entry
(fp32, sm_90a; the source's header says what bounds it and how it is laid
out; K3 shares the kernel) or raises; on CPU tensors it
runs ``keybias_attention_reference``, the plain PyTorch version of the same
function, which the tests hold to JAX and the chip check holds the kernel to.

``keybias_attention`` is differentiable on both devices: a
``torch.autograd.Function`` whose backward is ``attention_backward``, the
port of the JAX custom_vjp's ``_keybias_bwd``. That backward is plain XLA in
JAX, outside any Pallas kernel, and stays plain PyTorch here: it recomputes
the softmax and launches no kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .build import function, launch

HEAD_DIM_MAX = 128
# q, k, v, key_bias, out; B, H, T, S, d; the stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

# Kernel launches since the count was last set to 0 (the chip check zeroes
# it before driving the main path and reads it after).
launches = 0
_launches_lock = threading.Lock()


def _count_launch() -> None:
    global launches
    with _launches_lock:  # the server runs the pipeline from several threads
        launches += 1


def keybias_attention_reference(
    q: torch.Tensor,  # (B, H, T, d), pre-scaled
    k: torch.Tensor,  # (B, H, S, d)
    v: torch.Tensor,  # (B, H, S, d)
    key_bias: torch.Tensor,  # (B, S) additive (0 / -1e9 padding mask)
) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores, (B, S) bias broadcast over rows."""
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    scores = scores + key_bias.float()[:, None, None, :]
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", weights, v).to(q.dtype)


def attention_backward(q, k, v, bias, do):
    """The recompute backward of ``softmax(q . k^T + bias) . v`` (JAX's
    ``_keybias_bwd``), with ``bias`` broadcastable to (B, H, T, S). Returns
    (dq, dk, dv, ds); ds is the gradient of the biased scores, (B, H, T, S)."""
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) + bias.float()
    w = torch.softmax(s, dim=-1)
    do32 = do.float()
    dv = torch.einsum("bhts,bhtd->bhsd", w, do32)
    dw = torch.einsum("bhtd,bhsd->bhts", do32, v.float())
    ds = w * (dw - (dw * w).sum(-1, keepdim=True))
    dq = torch.einsum("bhts,bhsd->bhtd", ds, k.float())
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


def _check_cuda_inputs(q, k, v, key_bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or key_bias.dim() != 2:
        raise ValueError("expected q/k/v of rank 4 and key_bias of rank 2")
    B, H, T, d = q.shape
    S = k.shape[2]
    if k.shape != (B, H, S, d) or v.shape != (B, H, S, d) or key_bias.shape != (B, S):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} key_bias {tuple(key_bias.shape)}")
    if d % 8 or d > HEAD_DIM_MAX:
        raise ValueError(f"head_dim {d} must be a multiple of 8 and <= {HEAD_DIM_MAX}")
    for name, t in (("q", q), ("k", k), ("v", v), ("key_bias", key_bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (a view with an odd storage offset): the kernel copies K and V
    into shared memory 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(q, k, v, key_bias) -> torch.Tensor:
    if q.device.type == "cpu":
        return keybias_attention_reference(q, k, v, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"keybias_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_inputs(q, k, v, key_bias)
    B, H, T, d = q.shape
    S = k.shape[2]
    k, v = aligned16(k), aligned16(v)
    fn = function("bias_attention", "avi_keybias_attention_f32", _ARGTYPES)
    out = torch.empty_like(q)
    err = launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
                 out.data_ptr(), B, H, T, S, d)
    if err != 0:
        raise RuntimeError(f"keybias_attention kernel launch failed: cudaError {err}")
    _count_launch()
    return out


class _KeybiasAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_bias):
        ctx.save_for_backward(q, k, v, key_bias)
        return _forward(q, k, v, key_bias)

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias = ctx.saved_tensors
        dq, dk, dv, ds = attention_backward(q, k, v, key_bias[:, None, None, :], do)
        dkb = ds.sum((1, 2)).to(key_bias.dtype) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dkb


def keybias_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor
) -> torch.Tensor:
    """(B, H, T, d) attention output, differentiable. CPU tensors take the
    plain version; CUDA tensors take the kernel, which raises on what it
    does not take (non-fp32, non-contiguous, head_dim not a multiple of 8 or
    above 128). The gradient of ``key_bias`` is computed only when it
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, key_bias)):
        return _KeybiasAttention.apply(q, k, v, key_bias)
    return _forward(q, k, v, key_bias)  # inference: no autograd node to build
