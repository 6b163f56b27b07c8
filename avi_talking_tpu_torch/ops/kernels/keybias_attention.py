"""Key-bias attention: ``softmax(q . k^T + key_bias[b]) . v`` per (b, h).

The port of ``avi_talking_tpu/ops/pallas/attention.py::fused_keybias_attention``
(the TPU kernel K1). On CUDA tensors ``keybias_attention`` launches the
hand-written kernel ``csrc/keybias_attention.cu`` (fp32, sm_90a; its header
says what bounds it and how it is laid out) or raises; on CPU tensors it
runs ``keybias_attention_reference``, the plain PyTorch version of the same
function, which the tests hold to JAX and the chip check holds the kernel to.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

HEAD_DIM_MAX = 128

# Kernel launches since the count was last set to 0 (the chip check zeroes
# it before driving the main path and reads it after).
launches = 0


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


def _check_cuda_inputs(q, k, v, key_bias) -> None:
    if any(t.requires_grad for t in (q, k, v, key_bias)):
        raise NotImplementedError(
            "keybias_attention has no backward on CUDA yet; it comes with the "
            "training slice (the JAX backward is _keybias_bwd)")
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


def keybias_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor
) -> torch.Tensor:
    """(B, H, T, d) attention output. CPU tensors take the plain version;
    CUDA tensors take the kernel, which raises on what it does not take
    (non-fp32, non-contiguous, head_dim not a multiple of 8 or above 128,
    inputs that require grad)."""
    global launches
    if q.device.type == "cpu":
        return keybias_attention_reference(q, k, v, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"keybias_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_inputs(q, k, v, key_bias)
    B, H, T, d = q.shape
    S = k.shape[2]
    lib = load("keybias_attention")
    fn = lib.avi_keybias_attention_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
                 out.data_ptr(), B, H, T, S, d, stream)
    if err != 0:
        raise RuntimeError(f"keybias_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
