"""Key-bias attention: ``softmax(q . k^T + key_bias[b]) . v`` per (b, h).

The port of ``avi_talking_tpu/ops/pallas/attention.py::fused_keybias_attention``
(the TPU kernel K1). On CUDA tensors ``keybias_attention`` launches a
hand-written kernel for sm_90a or raises: float32 inputs go to
``csrc/bias_attention.cu``'s key-bias entry (K3 shares that kernel),
bfloat16 inputs (the product's ``--bf16`` mode) to
``csrc/keybias_attention_bf16.cu``; each source's header says what bounds
it and how it is laid out. On CPU tensors it runs
``keybias_attention_reference``, the plain PyTorch version of the same
function at either dtype, which the tests hold to JAX and the chip check
holds the kernels to.

``keybias_attention`` is differentiable on both devices: a
``torch.autograd.Function`` whose backward is ``attention_backward``, the
port of the JAX custom_vjp's ``_keybias_bwd``. That backward is plain XLA in
JAX, outside any Pallas kernel, and stays plain PyTorch here: it recomputes
the softmax in float32 and casts the gradients to the inputs' dtypes, as
``_keybias_bwd`` does, and launches no kernel.
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
# it before driving the main path and reads it after): ``launches`` of the
# float32 kernel, ``launches_bf16`` of the bfloat16 one.
launches = 0
launches_bf16 = 0
_launches_lock = threading.Lock()


def _count_launch(bf16: bool = False) -> None:
    global launches, launches_bf16
    with _launches_lock:  # the server runs the pipeline from several threads
        if bf16:
            launches_bf16 += 1
        else:
            launches += 1


def keybias_attention_reference(
    q: torch.Tensor,  # (B, H, T, d), pre-scaled
    k: torch.Tensor,  # (B, H, S, d)
    v: torch.Tensor,  # (B, H, S, d)
    key_bias: torch.Tensor,  # (B, S) additive (0 / -1e9 padding mask)
) -> torch.Tensor:
    """Plain PyTorch version, as ``_attn_kernel_keybias`` computes at any
    input dtype: fp32 scores from the products of q and k, the (B, S) bias
    read as fp32 and broadcast over rows, the softmax's weights cast to v's
    dtype, P . V accumulated in fp32, the output cast to q's dtype."""
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    scores = scores + key_bias.float()[:, None, None, :]
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhsd->bhtd", weights.float(), v.float()).to(q.dtype)


def bf16_disagreement(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far the bfloat16 kernel's output ``got`` lies from ``ref``, the
    plain version's on the same inputs, against the limit that holds it.
    Both round P and the output to bfloat16 from float32 values that differ
    only in summation order and the exponential's last bits (about 2^-20
    relative), so a value near a rounding midpoint may round the other way.
    An output that does so moves one bfloat16 step, at most 2^-7 |ref| (8
    significant bits); a flipped P_j moves the output's float32 value by at
    most 2^-7 p_j |v_j|, for which 2^-9 max|ref| is allowed. So each element
    is held within 2^-7 |ref| + 2^-9 max|ref|. Few elements flip, so the rms
    stays far below one step: it is held within 2^-11 rms(ref), plus one
    element's step of 2^-7 max|ref| spread over the N elements (what a
    single flip in a small tensor gives). A CPU emulation at the generate
    shapes (float64 sums, the same rounding points) reads rms 2^-14 rms(ref)
    with 0.05% of the outputs flipped; one in the card kernel's order (keys
    split over four warps, exp2 and a reciprocal of the sum) rms 2^-13.9
    with 0.04% flipped. A wrong kernel does not pass: P mis-normalised by
    1% reads ``worst`` 1.6, by 0.4% rms 2^-7.6 rms(ref); the one-pass
    softmax that rounds the unnormalised exponentials reads rms 2^-8.4
    rms(ref), half the outputs flipped.

    Returns ``worst`` and ``rms_worst``, the largest element's and the rms's
    share of their limits (at most 1 each passes), ``rms_rel``,
    rms(got - ref) / rms(ref), ``max_abs`` and ``flipped``, the share of
    elements that differ."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    top = float(ref.abs().max())
    ref_rms, rms = float(ref.pow(2).mean().sqrt()), float(diff.pow(2).mean().sqrt())
    rms_limit = 2.0 ** -11 * ref_rms + 2.0 ** -7 * top / ref.numel() ** 0.5
    return {"worst": float((diff / (2.0 ** -7 * ref.abs() + 2.0 ** -9 * top)).max()),
            "rms_worst": rms / rms_limit, "rms_rel": rms / ref_rms,
            "max_abs": float(diff.max()), "flipped": float((diff > 0).float().mean())}


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
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q is {q.dtype}; the kernels take float32 or bfloat16")
    step = 16 if q.dtype == torch.bfloat16 else 8
    if d % step or d > HEAD_DIM_MAX:
        raise ValueError(f"head_dim {d} must be a multiple of {step} and <= {HEAD_DIM_MAX} "
                         f"at {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("key_bias", key_bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}: one dtype for all four")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (a view with an odd storage offset): the kernels copy q (the
    bfloat16 one), K and V into shared memory 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(q, k, v, key_bias) -> torch.Tensor:
    if q.device.type == "cpu":
        return keybias_attention_reference(q, k, v, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"keybias_attention runs on cpu or cuda, not {q.device}")
    _check_cuda_inputs(q, k, v, key_bias)
    B, H, T, d = q.shape
    S = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    if bf16:
        fn = function("keybias_attention_bf16", "avi_keybias_attention_bf16", _ARGTYPES)
    else:
        fn = function("bias_attention", "avi_keybias_attention_f32", _ARGTYPES)
    out = torch.empty_like(q)
    err = launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
                 out.data_ptr(), B, H, T, S, d)
    if err != 0:
        raise RuntimeError(f"keybias_attention kernel launch failed: cudaError {err}")
    _count_launch(bf16)
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
    plain version; CUDA tensors take the kernel of their dtype, which raises
    on what it does not take (dtypes other than float32 or bfloat16, mixed
    dtypes, non-contiguous tensors, head_dim above 128 or not a multiple of
    8 at float32, of 16 at bfloat16). The gradient of ``key_bias`` is computed only when it
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, key_bias)):
        return _KeybiasAttention.apply(q, k, v, key_bias)
    return _forward(q, k, v, key_bias)  # inference: no autograd node to build
