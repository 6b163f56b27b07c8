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
// What bounds it: the fp32 issue rate, not the FMA peak. The kernel walks
// every (pixel, live slot) pair of a tile: about 15 fp32 instructions each
// (two offsets, two edge functions of four, w2 of two, three sign tests)
// and 6 more for a covered pair (the depth and its compare). None of them
// may contract, so each is one issue slot of one lane: 128 lanes a cycle
// per SM, half the FMA peak's operation count. Traffic is 4 bytes per
// slot, 36 more per valid one and 16 per pixel, far below that at every
// shape the render path gives it. Most pairs of a mesh of small faces lie outside the face's bounding
// box; the walk evaluates them all, which a test of the box could skip, so
// chip_smoke.py's bound counts only the pairs in the box.
//
// Design:
//   * grid (pixel block, tile): blockIdx.x picks a block of BLOCK_PX pixels
//     of a tile, blockIdx.y the tile (tiles past gridDim.y, 65535, loop).
//     A block owns its pixels outright, so no merge across blocks exists and
//     the tie rule cannot break; a tile's pixels spread over
//     ceil(px_n / BLOCK_PX) blocks, so a tile with many faces is shared by
//     several SMs and a tile with none costs one pass over `valid`;
//   * each thread owns PPT consecutive pixels of the block and keeps their
//     running (z, slot) in registers; a warp whose pixels all lie past px_n
//     stages but does not walk, so a ragged last block costs its live warps.
//     256 threads of one pixel each: 4 blocks a tile at tile 32, 13 at tile
//     56 (the last holds 64 pixels and walks with 2 of its 8 warps). Of the
//     blocks of 128 to 1024 pixels and 1 to 7 pixels a thread measured on
//     the card (scripts/torch_visibility_variants.py), this was fastest on
//     the head mesh and within 5 % of the fastest at the render path's
//     launch;
//   * the tile's slots are staged STAGE at a time, one per thread. A thread
//     reads its slot's `valid` and, only when it is set, the slot's corners;
//     its `ok` is valid > 0 and |denom| > 1e-12, as in the plain version.
//     A warp ballot, __popc of the lanes below, and the warps' counts in
//     shared memory give each live slot its place: live slots are written to the
//     shared face records in slot order, each with its original index
//     c0 + s, and the walk covers the live records alone. Compaction keeps
//     the order, so the strict `<` still keeps the first slot that reaches
//     the minimum; an invalid or degenerate slot could never win, so leaving
//     it out changes nothing, and an invalid slot's corners (NaN or inf
//     included) are not even read. Nothing assumes that live slots come
//     first, and no count of them comes from the host;
//   * a face record is three float4 in shared memory, {a0, b0, a1, b1},
//     {x2, y2, 1 / denom, z0}, {z1, z2, slot, -}: three 16-byte broadcast
//     loads per face for the PPT pixels of a thread.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = 1;                       // pixels per thread
constexpr int BLOCK_PX = THREADS * PPT;      // pixels per block
constexpr int STAGE = THREADS;               // slots staged per step
constexpr int MAX_GRID_Y = 65535;
constexpr float BIG = 1e9f;

__global__ void __launch_bounds__(THREADS)
rasterize_visibility_kernel(const float* __restrict__ tri,
                            const float* __restrict__ valid,
                            const float* __restrict__ px,
                            const float* __restrict__ py,
                            float* __restrict__ zbuf,
                            int* __restrict__ slot,
                            int n, int cap, int px_n) {
  __shared__ float4 s_edge[STAGE];   // a0, b0, a1, b1
  __shared__ float4 s_base[STAGE];   // x2, y2, 1 / denom, z0
  __shared__ float4 s_depth[STAGE];  // z1, z2, slot (int bits), unused
  __shared__ int s_count[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int first = (int)blockIdx.x * BLOCK_PX;      // the block's first pixel
  const int p0 = first + tid * PPT;                   // this thread's first pixel
  const bool walks = first + warp * 32 * PPT < px_n;  // a pixel of this warp is in the tile

  for (size_t t = blockIdx.y; t < (size_t)n; t += gridDim.y) {
    const float* tri_t = tri + t * (size_t)cap * 9;
    const float* valid_t = valid + t * (size_t)cap;
    float qx[PPT], qy[PPT], best[PPT];
    int best_slot[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + j;
      qx[j] = p < px_n ? px[t * (size_t)px_n + p] : 0.f;
      qy[j] = p < px_n ? py[t * (size_t)px_n + p] : 0.f;
      best[j] = BIG;
      best_slot[j] = -1;
    }

    for (int c0 = 0; c0 < cap; c0 += STAGE) {
      const int s = c0 + tid;
      bool ok = false;
      float4 edge, base, depth;
      if (s < cap && valid_t[s] > 0.f) {
        const float* f = tri_t + (size_t)s * 9;
        const float x0 = f[0], y0 = f[1], x1 = f[3], y1 = f[4];
        const float x2 = f[6], y2 = f[7];
        const float a0 = __fsub_rn(y1, y2), b0 = __fsub_rn(x2, x1);
        const float denom = __fadd_rn(__fmul_rn(a0, __fsub_rn(x0, x2)),
                                      __fmul_rn(b0, __fsub_rn(y0, y2)));
        ok = fabsf(denom) > 1e-12f;
        edge = make_float4(a0, b0, __fsub_rn(y2, y0), __fsub_rn(x0, x2));
        base = make_float4(x2, y2, __frcp_rn(denom), f[2]);
        depth = make_float4(f[5], f[8], __int_as_float(s), 0.f);
      }
      const unsigned live = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) s_count[warp] = __popc(live);
      __syncthreads();  // the counts are in; every warp has left the last walk
      int at = 0, total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int c = s_count[w];
        at += w < warp ? c : 0;
        total += c;
      }
      if (ok) {
        const int i = at + __popc(live & ((1u << lane) - 1u));
        s_edge[i] = edge;
        s_base[i] = base;
        s_depth[i] = depth;
      }
      __syncthreads();  // the live records are in, in slot order

      if (!walks) continue;
      for (int i = 0; i < total; ++i) {
        const float4 e = s_edge[i], b = s_base[i], d = s_depth[i];
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float dx = __fsub_rn(qx[j], b.x), dy = __fsub_rn(qy[j], b.y);
          const float w0 = __fmul_rn(__fadd_rn(__fmul_rn(e.x, dx), __fmul_rn(e.y, dy)), b.z);
          const float w1 = __fmul_rn(__fadd_rn(__fmul_rn(e.z, dx), __fmul_rn(e.w, dy)), b.z);
          const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
          if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
            const float z = __fadd_rn(__fadd_rn(__fmul_rn(w0, b.w), __fmul_rn(w1, d.x)),
                                      __fmul_rn(w2, d.y));
            if (z < best[j]) {
              best[j] = z;
              best_slot[j] = __float_as_int(d.z);
            }
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = p0 + j;
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
  // pixel indices of the last block stay inside int
  if (n < 0 || cap < 0 || px_n < 0 || px_n > INT_MAX - BLOCK_PX) return (int)cudaErrorInvalidValue;
  if (n == 0 || px_n == 0) return (int)cudaSuccess;  // empty output
  const dim3 grid((unsigned)(px_n / BLOCK_PX + (px_n % BLOCK_PX != 0)),
                  (unsigned)min(n, MAX_GRID_Y));
  rasterize_visibility_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      tri, valid, px, py, zbuf, slot, n, cap, px_n);
  return (int)cudaGetLastError();
}

