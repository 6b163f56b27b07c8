"""Per-tile z-buffer visibility for the binned rasterizer.

The port of ``avi_talking_tpu/ops/pallas/rasterize.py::rasterize_tiles_visibility``
(the TPU kernel K2). For every tile and every pixel of the tile it walks the
tile's ``cap`` binned face slots and returns the depth and slot of the
nearest face that covers the pixel centre; ties go to the first slot. On
CUDA tensors ``rasterize_tiles_visibility`` launches the hand-written kernel
``csrc/rasterize_visibility.cu`` (fp32, sm_90a; its header says what bounds
it and how it is laid out) or raises; on CPU tensors it runs
``rasterize_tiles_visibility_reference``, the plain PyTorch version, which
the tests hold to JAX and the chip check holds the kernel to, bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from .build import function, launch

BIG = 1e9
# tri, valid, px, py, zbuf, slot; n, cap, px_n; the stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

# Kernel launches since the count was last set to 0 (the chip check zeroes
# it before driving the render path and reads it after).
launches = 0
_launches_lock = threading.Lock()


def _count_launch() -> None:
    global launches
    with _launches_lock:  # the server runs the pipeline from several threads
        launches += 1


def rasterize_tiles_visibility_reference(
    tri: torch.Tensor,  # (n, cap, 9) corner xyz flattened
    valid: torch.Tensor,  # (n, cap, 1) float 0 / 1
    px: torch.Tensor,  # (n, px_n) pixel centres, x
    py: torch.Tensor,  # (n, px_n) pixel centres, y
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, chunked over the face slots like the TPU
    kernel: per chunk the smallest z and the first row that holds it, then a
    strict ``<`` against the running z-buffer. One reciprocal per face, each
    op rounded on its own, so the CUDA kernel can be held to it bit for bit.
    -> (zbuf (n, px_n) f32, BIG where empty; slot (n, px_n) int32, -1 where
    empty)."""
    n, cap, _ = tri.shape
    px_n = px.shape[1]
    zbuf = torch.full((n, px_n), BIG, dtype=torch.float32, device=tri.device)
    slot = torch.full((n, px_n), -1, dtype=torch.int32, device=tri.device)
    px1, py1 = px[:, None, :], py[:, None, :]
    for c0 in range(0, cap, chunk):
        t = tri[:, c0:c0 + chunk]  # (n, ch, 9)
        x0, y0, z0 = t[..., 0:1], t[..., 1:2], t[..., 2:3]
        x1, y1, z1 = t[..., 3:4], t[..., 4:5], t[..., 5:6]
        x2, y2, z2 = t[..., 6:7], t[..., 7:8], t[..., 8:9]
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        ok = denom.abs() > 1e-12
        inv = 1.0 / torch.where(ok, denom, torch.ones_like(denom))
        w0 = ((y1 - y2) * (px1 - x2) + (x2 - x1) * (py1 - y2)) * inv
        w1 = ((y2 - y0) * (px1 - x2) + (x0 - x2) * (py1 - y2)) * inv
        w2 = 1.0 - w0 - w1  # (n, ch, px_n)
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok & (valid[:, c0:c0 + chunk] > 0)
        z = torch.where(inside, w0 * z0 + w1 * z1 + w2 * z2, BIG)
        best_z = z.amin(dim=1)  # (n, px_n)
        rows = torch.arange(t.shape[1], device=tri.device, dtype=torch.int32)[None, :, None]
        row = torch.where(z <= best_z[:, None], rows, cap).amin(dim=1)
        closer = best_z < zbuf
        zbuf = torch.where(closer, best_z, zbuf)
        slot = torch.where(closer, row + c0, slot)
    return zbuf, slot


def _check_cuda_inputs(tri, valid, px, py) -> None:
    if any(t.requires_grad for t in (tri, valid, px, py)):
        raise NotImplementedError(
            "rasterize_tiles_visibility is a stop-gradient decision; on CUDA it "
            "takes no inputs that require grad (gradients flow through the "
            "interpolation in viz.rasterizer.rasterize_binned_kernel)")
    if tri.dim() != 3 or tri.shape[2] != 9 or valid.dim() != 3 or px.dim() != 2:
        raise ValueError("expected tri (n, cap, 9), valid (n, cap, 1), px / py (n, px_n)")
    n, cap, _ = tri.shape
    if valid.shape != (n, cap, 1) or px.shape[0] != n or py.shape != px.shape:
        raise ValueError(
            f"shape mismatch: tri {tuple(tri.shape)} valid {tuple(valid.shape)} "
            f"px {tuple(px.shape)} py {tuple(py.shape)}")
    if max(n, cap, px.shape[1]) >= 2 ** 31:
        raise ValueError(f"sizes past the kernel's int range: n {n} cap {cap} px_n {px.shape[1]}")
    for name, t in (("tri", tri), ("valid", valid), ("px", px), ("py", py)):
        if t.device != tri.device:
            raise ValueError(f"{name} is on {t.device}, tri on {tri.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rasterize_tiles_visibility(
    tri: torch.Tensor, valid: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (zbuf (n, px_n) f32, slot (n, px_n) int32, -1 = empty). CPU
    tensors take the plain version (in slot chunks of ``chunk``); CUDA
    tensors take the kernel, which raises on what it does not take
    (non-fp32, non-contiguous, mismatched shapes, inputs that require
    grad). The kernel's result does not depend on ``chunk``."""
    if tri.device.type == "cpu":
        return rasterize_tiles_visibility_reference(tri, valid, px, py, chunk)
    if tri.device.type != "cuda":
        raise ValueError(f"rasterize_tiles_visibility runs on cpu or cuda, not {tri.device}")
    _check_cuda_inputs(tri, valid, px, py)
    n, cap, _ = tri.shape
    px_n = px.shape[1]
    fn = function("rasterize_visibility", "avi_rasterize_visibility_f32", _ARGTYPES)
    zbuf = torch.empty((n, px_n), dtype=torch.float32, device=tri.device)
    slot = torch.empty((n, px_n), dtype=torch.int32, device=tri.device)
    err = launch(fn, tri.device, tri.data_ptr(), valid.data_ptr(), px.data_ptr(), py.data_ptr(),
                 zbuf.data_ptr(), slot.data_ptr(), n, cap, px_n)
    if err != 0:
        raise RuntimeError(f"rasterize_tiles_visibility kernel launch failed: cudaError {err}")
    _count_launch()
    return zbuf, slot
