// Per-tile z-buffer visibility for the binned rasterizer, fp32, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel avi_talking_tpu/ops/pallas/rasterize.py
// ::rasterize_tiles_visibility (pl.pallas_call of _make_visibility_kernel).
// For each tile t and each pixel p of the tile it walks the tile's `cap`
// binned face slots and keeps the nearest covering face:
//
//     w0, w1 = edge functions of (px, py) times 1 / denom, w2 = 1 - w0 - w1
//     covered = w0, w1, w2 >= 0 and |denom| > 1e-12 and valid[t, s] > 0
//     z = w0 z0 + w1 z1 + w2 z2;   keep (z, s) when z < best (strict)
//
// The walk runs in slot order with a strict `<` from z = 1e9, so the winner
// is the first slot that reaches the minimum, as in the TPU kernel (smallest
// row inside a chunk, strict `<` across chunks). An empty pixel keeps
// z = 1e9 and slot -1. The slot is written as int32.
//
// Arithmetic: every op of the barycentric and depth math is an explicitly
// rounded intrinsic (__fmul_rn / __fadd_rn / __fsub_rn / __frcp_rn, which
// nvcc never contracts into an FMA), in the order of the plain PyTorch
// version (ops/kernels/rasterize.py), so zbuf and slot are bit-equal to it.
//
// What bounds it: about 15 fp32 operations per (pixel, valid slot) pair
// (two offsets, two edge functions, w2, three sign tests) plus 6 for a
// covered pair (the depth and its compare), against 40 bytes per slot and
// 16 bytes per pixel of traffic. At the render path's launch (16 frames x
// 64 tiles, cap 1024, 1024 pixels a tile) that is about 1.07e9 pairs, some
// 16 GFLOP against 59 MB: the fp32 (non tensor core) rate bounds it, not
// the memory rate.
//
// Design (simple and right first):
//   * one block of 256 threads per tile; each thread owns 4 pixels of a
//     1024-pixel pass (px_n = 1024 at tile 32 is one pass, 3136 at tile 56
//     four), keeping its running (z, slot) per pixel in registers;
//   * the tile's faces are staged through shared memory 256 slots at a
//     time: each thread turns one slot's 9 corner values into the per-face
//     terms (edge coefficients, 1 / denom, depths, a covered-at-all flag),
//     computed once per face instead of once per (face, pixel); every
//     thread then reads the same face (a shared-memory broadcast), so the
//     skip of an invalid or degenerate slot is uniform across the warp;
//   * ragged sizes: `cap` need not be a multiple of 256 nor px_n of 1024;
//     slots past `cap` are never staged and pixels past px_n never written.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int PPT = 4;                      // pixels per thread per pass
constexpr int PASS = THREADS * PPT;         // pixels per pass
constexpr int STAGE = THREADS;              // face slots staged per step
constexpr float BIG = 1e9f;

__global__ void __launch_bounds__(THREADS)
rasterize_visibility_kernel(const float* __restrict__ tri,
                            const float* __restrict__ valid,
                            const float* __restrict__ px,
                            const float* __restrict__ py,
                            float* __restrict__ zbuf,
                            int* __restrict__ slot,
                            int cap, int px_n) {
  __shared__ float s_a0[STAGE], s_b0[STAGE], s_a1[STAGE], s_b1[STAGE];
  __shared__ float s_x2[STAGE], s_y2[STAGE], s_inv[STAGE];
  __shared__ float s_z0[STAGE], s_z1[STAGE], s_z2[STAGE];
  __shared__ int s_ok[STAGE];

  const size_t t = blockIdx.x;
  const int tid = threadIdx.x;
  const float* tri_t = tri + t * (size_t)cap * 9;
  const float* valid_t = valid + t * (size_t)cap;
  const float* px_t = px + t * (size_t)px_n;
  const float* py_t = py + t * (size_t)px_n;

  for (int p0 = 0; p0 < px_n; p0 += PASS) {
    float qx[PPT], qy[PPT], best[PPT];
    int best_slot[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + tid + j * THREADS;
      qx[j] = p < px_n ? px_t[p] : 0.f;
      qy[j] = p < px_n ? py_t[p] : 0.f;
      best[j] = BIG;
      best_slot[j] = -1;
    }

    for (int c0 = 0; c0 < cap; c0 += STAGE) {
      const int nf = min(STAGE, cap - c0);
      __syncthreads();  // the previous step's faces are read
      if (tid < nf) {
        const float* f = tri_t + (size_t)(c0 + tid) * 9;
        const float x0 = f[0], y0 = f[1], x1 = f[3], y1 = f[4];
        const float x2 = f[6], y2 = f[7];
        const float a0 = __fsub_rn(y1, y2), b0 = __fsub_rn(x2, x1);
        const float denom = __fadd_rn(__fmul_rn(a0, __fsub_rn(x0, x2)),
                                      __fmul_rn(b0, __fsub_rn(y0, y2)));
        const bool nondegenerate = fabsf(denom) > 1e-12f;
        s_a0[tid] = a0;
        s_b0[tid] = b0;
        s_a1[tid] = __fsub_rn(y2, y0);
        s_b1[tid] = __fsub_rn(x0, x2);
        s_x2[tid] = x2;
        s_y2[tid] = y2;
        s_inv[tid] = __frcp_rn(nondegenerate ? denom : 1.f);
        s_z0[tid] = f[2];
        s_z1[tid] = f[5];
        s_z2[tid] = f[8];
        s_ok[tid] = nondegenerate && valid_t[c0 + tid] > 0.f;
      }
      __syncthreads();

      for (int s = 0; s < nf; ++s) {
        if (!s_ok[s]) continue;
        const float a0 = s_a0[s], b0 = s_b0[s], a1 = s_a1[s], b1 = s_b1[s];
        const float x2 = s_x2[s], y2 = s_y2[s], inv = s_inv[s];
        const float z0 = s_z0[s], z1 = s_z1[s], z2 = s_z2[s];
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float dx = __fsub_rn(qx[j], x2), dy = __fsub_rn(qy[j], y2);
          const float w0 = __fmul_rn(__fadd_rn(__fmul_rn(a0, dx), __fmul_rn(b0, dy)), inv);
          const float w1 = __fmul_rn(__fadd_rn(__fmul_rn(a1, dx), __fmul_rn(b1, dy)), inv);
          const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
          if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
            const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, z0), __fmul_rn(w1, z1)),
                                      __fmul_rn(w2, z2));
            if (z < best[j]) {
              best[j] = z;
              best_slot[j] = c0 + s;
            }
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + tid + j * THREADS;
      if (p < px_n) {
        zbuf[t * (size_t)px_n + p] = best[j];
        slot[t * (size_t)px_n + p] = best_slot[j];
      }
    }
  }
}

}  // namespace

// tri: (n, cap, 9); valid: (n, cap, 1); px, py: (n, px_n); zbuf: (n, px_n)
// fp32; slot: (n, px_n) int32. All contiguous, on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise.
extern "C" int avi_rasterize_visibility_f32(const float* tri, const float* valid,
                                            const float* px, const float* py,
                                            float* zbuf, int* slot, int n,
                                            int cap, int px_n, void* stream) {
  if (n < 0 || cap < 0 || px_n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || px_n == 0) return (int)cudaSuccess;  // empty output
  rasterize_visibility_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      tri, valid, px, py, zbuf, slot, cap, px_n);
  return (int)cudaGetLastError();
}
