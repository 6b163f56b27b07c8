#!/usr/bin/env python3
"""Throughput and latency of warp-level ``mma.sync`` on the card.

    python scripts/torch_mma_probe.py

Builds a small probe with nvcc (into build/mma_probe/) whose warps each run
``chains`` independent accumulator chains of one mma shape in a loop, and
prints one JSON line per (shape, chains per warp, warps per SM): the rate in
TFLOP/s and the cycles per mma per warp at the card's clock. One chain per
warp at 4 warps per SM reads the dependent-mma latency; many chains at 8 or
more warps per SM the issue rate. The port's attention kernel
(csrc/bias_attention.cu) is built on the TF32 m16n8k8 shape.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE(NAME, INSTR)                                                    \
  template <int CH>                                                           \
  __global__ void NAME(float* out, int iters) {                               \
    float c[CH][4] = {};                                                      \
    uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3;                    \
    for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 1);                 \
    for (int it = 0; it < iters; ++it)                                        \
      _Pragma("unroll") for (int j = 0; j < CH; ++j)                          \
        asm volatile(INSTR " {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "         \
                     "{%0,%1,%2,%3};"                                         \
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]),           \
                       "+f"(c[j][3])                                          \
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),   \
                       "r"(b1));                                              \
    float s = 0;                                                              \
    for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];  \
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;                           \
  }

PROBE(tf32_k8, "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32")
PROBE(f16_k16, "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32")
PROBE(bf16_k16, "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32")

#define LAUNCH(K)                                                   \
  if (chains == 1) K<1><<<blocks, 128, 0, s>>>(out, iters);          \
  else if (chains == 4) K<4><<<blocks, 128, 0, s>>>(out, iters);     \
  else K<8><<<blocks, 128, 0, s>>>(out, iters);

extern "C" int probe(int kind, int chains, int blocks, int iters, float* out,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) { LAUNCH(tf32_k8) } else if (kind == 1) { LAUNCH(f16_k16) }
  else { LAUNCH(bf16_k16) }
  return (int)cudaGetLastError();
}
"""

SHAPES = ((0, "tf32_m16n8k8", 16 * 8 * 8), (1, "f16_m16n8k16", 16 * 8 * 16),
          (2, "bf16_m16n8k16", 16 * 8 * 16))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mma_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from avi_talking_tpu_torch.ops.kernels import build

    out_dir = os.path.join(ROOT, "build", "mma_probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "probe.cu"), os.path.join(out_dir, "libprobe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    out = torch.empty(sms * 4 * 128, device="cuda")
    iters = 4096
    for kind, name, fma in SHAPES:
        for chains in (1, 4, 8):
            for warps_per_sm in (4, 8, 16):
                blocks = sms * warps_per_sm // 4

                def go():
                    err = lib.probe(kind, chains, blocks, iters, out.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err

                go()
                torch.cuda.synchronize()
                times = []
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    go()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / 1e3)
                sec = min(times)
                mmas = blocks * 4 * chains * iters
                print(json.dumps({
                    "mma": name, "chains_per_warp": chains, "warps_per_sm": warps_per_sm,
                    "ms": sec * 1e3, "tflops": 2 * fma * mmas / sec / 1e12,
                    "cycles_per_mma_per_warp": sec * clock_hz / (chains * iters),
                    "clock_mhz": clock_hz / 1e6}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
