#!/usr/bin/env python3
"""Where a block of the bfloat16 attention kernel (K1's and K3's bfloat16
entries) spends its time, on the card.

    python scripts/torch_bf16_timeline.py

Builds avi_talking_tpu_torch/csrc/keybias_attention_bf16.cu with marks added
at its section boundaries (thread 0, a consumer, reads clock64 there and
writes it to a __device__ array), runs K1's entry at chip_smoke.py's bf16
kernel-check shapes (chip_smoke.BF16_CASES and BF16_STREAMED) and K3's bias
entry at the FaceFormer family's (chip_smoke.K3_BF16_CASES: the float32
(H, T, T) or (T, S) bias), and prints one JSON line per shape: the launch
(row groups of 16 query rows a block, blocks, K and V resident or streamed,
where the bias lies (staged, kept whole or ringed), the dynamic shared
memory a block takes, and how many blocks ran on each SM: {blocks: SMs});
per section, the median over blocks of the cycles from the block's start
to the section's end (set-up: barriers, zero rows, a staged bias or a
span's ends; q: the first copy group released; tile0: pass 1's first
tile; pass1, merge, pass2, end); and the spread of the blocks' start times (ns, %globaltimer), which shows
the waves. The marks cost a few instructions of one thread; the build goes
to build/variants/.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import subprocess
import sys

import kernel_variants

SECTIONS = [  # (mark, the text it goes before), in order; "end" goes after the output loop
    ("start", "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;"),
    ("setup", "  if (producer) {\n    // Streamed, at most"),
    ("q", "  uint32_t qf[D / 16][4];"),
    ("tile0", "    if (key0 < S) {\n      const int slot"),
    ("pass1", "  // The row group's M and L"),
    ("merge", "  // Pass 2: P = bf16"),
    ("pass2", "  // The four warps' partial sums"),
]
END = ("    if (rb < T) *reinterpret_cast<uint32_t*>(ob + (size_t)rb * D + col) = "
       "pack_bf16(a.z, a.w);\n  }\n")
PLACES = ("staged", "whole", "ringed")
HEADER = r"""
#include <cuda_runtime.h>
__device__ long long avi_marks[8192][10];
__device__ long long avi_launch[5];
#define MARK(k)                                                                     \
  do {                                                                              \
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;                            \
    if (threadIdx.x == 0 && blk < 8192 && avi_marks[blk][k] == 0) {                 \
      avi_marks[blk][k] = clock64();                                                \
      if ((k) == 0) {                                                               \
        long long ns;                                                               \
        unsigned smid;                                                              \
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                      \
        asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));                           \
        avi_marks[blk][9] = ns;                                                     \
        avi_marks[blk][8] = smid;                                                   \
      }                                                                             \
    }                                                                               \
  } while (0)
extern "C" int avi_marks_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, avi_marks, sizeof(avi_marks));
}
extern "C" int avi_launch_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, avi_launch, sizeof(avi_launch));
}
extern "C" int avi_marks_clear() {
  static long long zero[8192][10];
  return (int)cudaMemcpyToSymbol(avi_marks, zero, sizeof(zero));
}
"""
# what block 0 records of its launch: threads, blocks, K / V resident, shared
# memory bytes, where the bias lies (an index into PLACES)
LAUNCH = """  if (blockIdx.x == 0 && threadIdx.x == 0) {
    avi_launch[0] = blockDim.x;
    avi_launch[1] = gridDim.x;
    avi_launch[2] = resident;
    avi_launch[3] = (long long)pl.bytes;
    avi_launch[4] = kStaged ? 0 : resident ? 1 : 2;
  }
"""


def marked_source(text: str) -> str:
    for k, (_, anchor) in enumerate(SECTIONS):
        if text.count(anchor) != 1:
            raise SystemExit(f"the mark {SECTIONS[k][0]} no longer applies")
        extra = LAUNCH if k == 0 else ""
        text = text.replace(anchor, extra + f"  MARK({k});\n" + anchor)
    if text.count(END) != 1:
        raise SystemExit("the end mark no longer applies")
    return HEADER + text.replace(END, END + f"  MARK({len(SECTIONS)});\n")


def main() -> int:
    import numpy as np
    import torch

    cs = kernel_variants.chip_smoke("torch_bf16_timeline")
    from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
    from avi_talking_tpu_torch.ops.kernels import build

    with open(os.path.join(build.CSRC_DIR, "keybias_attention_bf16.cu")) as f:
        src = marked_source(f.read())
    out_dir = os.path.join(kernel_variants.ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    path, lib = os.path.join(out_dir, "kb_marks.cu"), os.path.join(out_dir, "libkb_marks.so")
    with open(path, "w") as f:
        f.write(src)
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(done.stdout + done.stderr)
    so = ctypes.CDLL(lib)
    key_entry = so.avi_keybias_attention_bf16
    key_entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bias_entry = so.avi_bias_attention_bf16
    bias_entry.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
                           + [ctypes.c_void_p])
    for fn in (key_entry, bias_entry):
        fn.restype = ctypes.c_int
    names = [name for name, _ in SECTIONS[1:]] + ["end"]

    runs = []  # (case, shape, bias, the launch)
    g = torch.Generator(device="cuda").manual_seed(1)
    for case, B, H, T, S, d, lens in cs.BF16_CASES + cs.BF16_STREAMED:
        q, k, v, bias = cs.bf16_inputs(B, H, T, S, d, lens, g)
        out = torch.empty_like(q)
        runs.append((case, [B, H, T, S, d], "(B, S) bfloat16 key bias",
                     lambda q=q, k=k, v=v, bias=bias, out=out, n=(B, H, T, S, d): key_entry(
                         q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), *n, torch.cuda.current_stream().cuda_stream)))
    g = torch.Generator(device="cuda").manual_seed(13)
    for case, B, H, T, d, kind in cs.K3_BF16_CASES:
        q, k, v, bias = cs.k3_bf16_inputs(B, H, T, d, kind, g)
        out = torch.empty_like(q)
        strides = kba.bias_strides(bias, B, H, T, T)
        runs.append((case, [B, H, T, T, d], f"{tuple(bias.shape)} float32",
                     lambda q=q, k=k, v=v, bias=bias, out=out, n=(B, H, T, T, d), st=strides:
                     bias_entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), *n, *st,
                                torch.cuda.current_stream().cuda_stream)))
    for case, shape, bias_kind, call in runs:
        assert call() == 0  # warm-up: the build's first launch raises the shared-memory limit
        torch.cuda.synchronize()
        assert so.avi_marks_clear() == 0
        assert call() == 0
        torch.cuda.synchronize()
        marks = np.zeros((8192, 10), np.int64)
        assert so.avi_marks_read(marks.ctypes.data) == 0
        launch = np.zeros(5, np.int64)
        assert so.avi_launch_read(launch.ctypes.data) == 0
        marks = marks[marks[:, 0] != 0]
        cycles = marks[:, 1:len(SECTIONS) + 1] - marks[:, :1]
        start_ns = marks[:, 9] - marks[:, 9].min()
        per_sm = collections.Counter(collections.Counter(marks[:, 8].tolist()).values())
        print(json.dumps({
            "case": case, "shape": shape, "bias": bias_kind,
            "groups": int((launch[0] - 32 * 4) // (32 * 4)), "threads": int(launch[0]),
            "blocks": int(launch[1]), "resident": bool(launch[2]),
            "bias_place": PLACES[launch[4]],
            "smem_bytes": int(launch[3]),
            "blocks_per_sm": {str(n): c for n, c in sorted(per_sm.items())},
            "median_cycles_from_start": {n: float(np.median(cycles[:, i]))
                                         for i, n in enumerate(names)},
            "start_ns_percentiles_0_50_90_100": [int(np.percentile(start_ns, p))
                                                 for p in (0, 50, 90, 100)]}), flush=True)
    kernel_variants.print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
