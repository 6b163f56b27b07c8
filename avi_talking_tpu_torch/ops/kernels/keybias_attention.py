"""Key-bias attention: ``softmax(q . k^T + key_bias[b]) . v`` per (b, h).

The port of ``avi_talking_tpu/ops/pallas/attention.py::fused_keybias_attention``
(the TPU kernel K1). On CUDA tensors ``keybias_attention`` launches a
hand-written kernel for sm_90a or raises: float32 q, k and v go to
``csrc/bias_attention.cu`` (K3 shares that kernel), bfloat16 ones (the
product's ``--bf16`` mode) to ``csrc/keybias_attention_bf16.cu`` (K3's
bfloat16 entry shares that one), each reading the (B, S) key bias through
the strides (S, 0, 0, 1); each source's header says what bounds it and how
it is laid out. On CPU tensors it runs ``keybias_attention_reference``, the
plain PyTorch version of the same function at either dtype, which the tests
hold to JAX and the chip check holds the kernels to.

The inputs both devices take are the Pallas kernels': q, k and v of one
dtype, float32 or bfloat16, with any head dim up to ``HEAD_DIM_MAX``; the
key bias float32 or bfloat16 whatever q's dtype, read as float32; any B*H.
float16 (which no path of either package sends) and a head dim above 128
raise. On the card the tensors must also be contiguous; a head dim that is
not a multiple of the kernel's step (8 at float32, 16 at bfloat16) is
zero-padded to the next one by ``launch_attention`` (zero columns add
nothing to q . k^T and give zero output columns, which it drops), so the
full-width configurations' d = 16, 32 and 64 take no copy.

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

import torch.nn.functional as F

from .build import function, launch

HEAD_DIM_MAX = 128
DTYPES = (torch.float32, torch.bfloat16)
# the head dim each kernel takes a multiple of, and its source and entry
HEAD_DIM_STEP = {torch.float32: 8, torch.bfloat16: 16}
_ENTRIES = {torch.float32: ("bias_attention", "avi_bias_attention_f32"),
            torch.bfloat16: ("keybias_attention_bf16", "avi_bias_attention_bf16")}
# q, k, v, bias, out; B, H, T, S, d; the bias strides (b, h, t, s); the stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
             + [ctypes.c_void_p])

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


def check_inputs(q, k, v, bias, bias_name: str) -> None:
    """What both devices hold the attention wrappers' inputs to (the
    Pallas kernels' contract): q (B, H, T, d), k and v (B, H, S, d) of one
    dtype, float32 or bfloat16; d from 1 to ``HEAD_DIM_MAX``; the bias
    float32 or bfloat16. Its shape is the caller's to check."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q/k/v of rank 4")
    B, H, T, d = q.shape
    S = k.shape[2]
    if k.shape != (B, H, S, d) or v.shape != (B, H, S, d):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q is {q.dtype}; the kernels take float32 or bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}: q, k and v share one dtype")
    if bias.dtype not in DTYPES:
        raise TypeError(f"{bias_name} is {bias.dtype}; the kernels read a float32 or "
                        f"bfloat16 bias")
    if d > HEAD_DIM_MAX:
        raise ValueError(f"head_dim {d} is above {HEAD_DIM_MAX}, the largest the kernels take")


def check_cuda_layout(q, k, v, bias, bias_name: str) -> None:
    """On the card: every input on q's device and contiguous."""
    for name, t in (("q", q), ("k", k), ("v", v), (bias_name, bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_key_bias(q, k, key_bias) -> None:
    B, S = q.shape[0], k.shape[2]
    if key_bias.dim() != 2 or key_bias.shape != (B, S):
        raise ValueError(f"key_bias {tuple(key_bias.shape)}; expected (B, S) = {(B, S)}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (a view with an odd storage offset): the kernels copy q (the
    bfloat16 one), K and V into shared memory 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_attention(q, k, v, bias, strides, what: str) -> torch.Tensor:
    """Launch the kernel of q's dtype on checked CUDA inputs, reading
    ``bias`` (of its own dtype) at the (b, h, t, s) element ``strides``.
    A head dim off the kernel's step is zero-padded to it and the output's
    padding dropped. Raises, naming ``what``, if the launch fails."""
    B, H, T, d = q.shape
    S = k.shape[2]
    step = HEAD_DIM_STEP[q.dtype]
    width = -(-d // step) * step
    if width != d:
        q, k, v = (F.pad(t, (0, width - d)) for t in (q, k, v))
    else:
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
    source, symbol = _ENTRIES[q.dtype]
    if bias.dtype == torch.bfloat16:
        symbol += "_bias_bf16"
    fn = function(source, symbol, _ARGTYPES)
    out = torch.empty_like(q)
    err = launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), B, H, T, S, width, *strides)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
    return out if width == d else out[..., :d].contiguous()


def _forward(q, k, v, key_bias) -> torch.Tensor:
    check_inputs(q, k, v, key_bias, "key_bias")
    _check_key_bias(q, k, key_bias)
    if q.device.type == "cpu":
        return keybias_attention_reference(q, k, v, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"keybias_attention runs on cpu or cuda, not {q.device}")
    check_cuda_layout(q, k, v, key_bias, "key_bias")
    out = launch_attention(q, k, v, key_bias, (k.shape[2], 0, 0, 1), "keybias_attention")
    _count_launch(q.dtype == torch.bfloat16)
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
    plain version; CUDA tensors take the kernel of q's dtype. Both raise on
    what the kernels do not take (``check_inputs``: dtypes other than
    float32 or bfloat16, q, k and v of mixed dtypes, head_dim above 128), and
    the kernels on non-contiguous tensors. The gradient of ``key_bias`` is
    computed only when it requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, key_bias)):
        return _KeybiasAttention.apply(q, k, v, key_bias)
    return _forward(q, k, v, key_bias)  # inference: no autograd node to build
