// Key-bias attention forward on bfloat16 inputs, for Hopper (sm_90a).
//
// Replaces the TPU kernel K1 of avi_talking_tpu/ops/pallas/attention.py,
// fused_keybias_attention (pl.pallas_call of _attn_kernel_keybias), where the
// JAX package's --bf16 mode runs it: every wav2vec2 encoder layer of the
// product path sends bfloat16 q, k, v and key bias (audio/wav2vec2.py). For
// each (batch b, head h):
//
//     out = bf16( P . V ),  P = bf16( exp(s - m) / l ),  s = q . k^T + key_bias[b]
//
// with q pre-scaled by the caller, s and the softmax in fp32, P rounded to
// bfloat16 (the Pallas kernel's weights.astype(v.dtype)), P . V accumulated
// in fp32 and the output rounded to bfloat16 (round to nearest even, as
// torch's .to(torch.bfloat16)). The float32 entry stays in bias_attention.cu.
//
// What bounds it: 4*B*H*T*S*d operations (the two products) against the
// bytes of q, k, v, the key bias and out, all bfloat16: T/2 operations per
// byte at T = S, under the H100's bf16 ridge of about 295 up to T of about
// 590, so the bytes bound the generate shapes (T=S=200..512) and the
// operations T=S=600; either way a launch there is well under a
// microsecond of work, and latency (two dependent passes over K) sets its
// time.
//
// Design (simple and exact first; wgmma / TMA is later work):
//   * both products on tensor cores in bfloat16 with fp32 accumulation,
//     mma.sync m16n8k16: the products of bfloat16 values are exact in fp32,
//     so no split is needed;
//   * the softmax is normalised BEFORE P is rounded, as the Pallas kernel
//     and the plain version do: two passes over K per query tile. Pass 1
//     forms q . k^T tile by tile and keeps each row's running max m and sum
//     l (the sum rescaled when the max grows); pass 2 forms q . k^T again,
//     P = exp(s - m) / l (IEEE division, expf), rounds P to bfloat16 and
//     accumulates P . V. A one-pass online softmax would round the
//     unnormalised exponentials instead, another quantity;
//   * one block of 4 warps per (64-query tile, b*h); warp w owns query rows
//     16w..16w+15 of the tile, holds its q fragments in registers for the
//     whole kernel and sees every key. K and V stream through shared memory
//     in 64-key tiles, loaded by the whole block 16 bytes at a time; keys
//     past S are zero-filled and excluded (-inf). A key masked by the
//     caller's finite bias still counts, so a row whose every bias is the
//     bf16 -1e9 is a uniform softmax, as on the TPU. Query rows past T are
//     computed on zeros and never written;
//   * P . V takes P straight from the score accumulators: for m16n8k16 the
//     accumulator of key columns 2t, 2t+1 of an 8-key tile is the A
//     fragment's layout, two 8-key tiles making one 16-key k step;
//   * shared rows are (d + 8) bfloat16 long, so the 32-bit K fragment loads
//     (rows g, words t) and the 16-bit V loads (rows 2t, 2t+1, column g) of
//     a warp fall in distinct banks;
//   * instantiations for d = 16, 32, ..., 128 (a multiple of 16; wav2vec2's
//     is 64) size the register tiles; __launch_bounds__(128, 1) lets ptxas
//     take the registers it needs (without the 1 it spills at d = 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block, 16 per warp
constexpr int BK = 64;          // keys per K / V tile
constexpr int DMAX = 128;

// c += a . b, m16n8k16, bf16 operands (a0..a3 the A fragment), fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bfloat16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows k0..k0+BK-1 of a (S, D) bfloat16 matrix into a (BK, D + 8) tile,
// 16 bytes a copy; rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int k0,
                                          int S) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int P = D + 8;
  for (int e = threadIdx.x; e < BK * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS, c = e - r * CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < S) val = *reinterpret_cast<const uint4*>(src + (size_t)(k0 + r) * D + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * P + 8 * c) = val;
  }
}

// s[j] = q . K^T for the warp's 16 rows and keys 8j..8j+7 of the tile in
// k_s, plus the key bias; keys past S are -inf.
template <int D>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* k_s, const __nv_bfloat16* kbias,
                                       int k0, int S, int g, int t) {
  constexpr int P = D + 8;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* krow = k_s + (8 * j + g) * P + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + 16 * kk);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + 16 * kk + 8);
      mma_bf16(s[j], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], b0, b1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + 8 * j + 2 * t + i;
      const float bias = key < S ? __bfloat162float(kbias[key]) : -INFINITY;
      s[j][i] = key < S ? s[j][i] + bias : -INFINITY;
      s[j][2 + i] = key < S ? s[j][2 + i] + bias : -INFINITY;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    keybias_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ key_bias,
                                  __nv_bfloat16* __restrict__ out, int H, int T, int S) {
  constexpr int P = D + 8;
  constexpr int NT = D / 8;  // 8-column output tiles
  __shared__ __align__(16) __nv_bfloat16 k_s[BK * P];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * P];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, b = bh / H;
  const int ra = blockIdx.x * BQ + 16 * warp + g, rb = ra + 8;
  const __nv_bfloat16* qb = q + (size_t)bh * T * D;
  const __nv_bfloat16* kb = k + (size_t)bh * S * D;
  const __nv_bfloat16* vb = v + (size_t)bh * S * D;
  const __nv_bfloat16* kbias = key_bias + (size_t)b * S;

  // A fragments of the warp's q rows: rows g / g+8, columns 2t, 2t+1 (+8).
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    qf[kk][0] = ra < T ? *reinterpret_cast<const uint32_t*>(qb + (size_t)ra * D + c) : 0u;
    qf[kk][1] = rb < T ? *reinterpret_cast<const uint32_t*>(qb + (size_t)rb * D + c) : 0u;
    qf[kk][2] = ra < T ? *reinterpret_cast<const uint32_t*>(qb + (size_t)ra * D + c + 8) : 0u;
    qf[kk][3] = rb < T ? *reinterpret_cast<const uint32_t*>(qb + (size_t)rb * D + c + 8) : 0u;
  }

  // Pass 1: each row's max m and sum l of exp(s - m). A thread keeps the
  // sum of its own keys; the quad's four are added at the end.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[BK / 8][4];
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile<D>(k_s, kb, k0, S);
    __syncthreads();
    scores<D>(s, qf, k_s, kbias, k0, S, g, t);
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
      x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
    }
    // finite: the tile holds key k0 < S, whose bias is finite
    const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
    l0 *= expf(m0 - n0);
    l1 *= expf(m1 - n1);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      l0 += expf(s[j][0] - n0) + expf(s[j][1] - n0);
      l1 += expf(s[j][2] - n1) + expf(s[j][3] - n1);
    }
    m0 = n0;
    m1 = n1;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // Pass 2: P = bf16(exp(s - m) / l), acc += P . V.
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const unsigned short* v16 = reinterpret_cast<const unsigned short*>(v_s);
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile<D>(k_s, kb, k0, S);
    load_tile<D>(v_s, vb, k0, S);
    __syncthreads();
    scores<D>(s, qf, k_s, kbias, k0, S, g, t);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float(&s0)[4] = s[2 * kk];
      const float(&s1)[4] = s[2 * kk + 1];
      const uint32_t p0 = pack_bf16(expf(s0[0] - m0) / l0, expf(s0[1] - m0) / l0);
      const uint32_t p1 = pack_bf16(expf(s0[2] - m1) / l1, expf(s0[3] - m1) / l1);
      const uint32_t p2 = pack_bf16(expf(s1[0] - m0) / l0, expf(s1[1] - m0) / l0);
      const uint32_t p3 = pack_bf16(expf(s1[2] - m1) / l1, expf(s1[3] - m1) / l1);
      const int r0 = (16 * kk + 2 * t) * P;  // V rows 16kk+2t, +1, +8, +9
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = 8 * n + g;
        const uint32_t b0 = (uint32_t)v16[r0 + c] | ((uint32_t)v16[r0 + P + c] << 16);
        const uint32_t b1 =
            (uint32_t)v16[r0 + 8 * P + c] | ((uint32_t)v16[r0 + 9 * P + c] << 16);
        mma_bf16(acc[n], p0, p1, p2, p3, b0, b1);
      }
    }
  }

  __nv_bfloat16* ob = out + (size_t)bh * T * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (ra < T)
      *reinterpret_cast<uint32_t*>(ob + (size_t)ra * D + c) = pack_bf16(acc[n][0], acc[n][1]);
    if (rb < T)
      *reinterpret_cast<uint32_t*>(ob + (size_t)rb * D + c) = pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
cudaError_t launch_d(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const __nv_bfloat16* key_bias, __nv_bfloat16* out, int B, int H, int T,
                     int S, cudaStream_t stream) {
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  keybias_attention_bf16_kernel<D><<<grid, THREADS, 0, stream>>>(q, k, v, key_bias, out, H, T, S);
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, H, T, d); k, v: (B, H, S, d); key_bias: (B, S), broadcast over
// heads and query rows. All bfloat16, contiguous, on the current device;
// q and out 4-byte aligned, k and v 16-byte aligned; d a multiple of 16 up
// to 128. Launches on `stream` and returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int avi_keybias_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* key_bias, void* out, int B, int H, int T,
                                          int S, int d, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || d <= 0 || d > DMAX || d % 16 ||
      (long long)B * H > 65535 || (uintptr_t)q % 4 || (uintptr_t)out % 4 ||
      (uintptr_t)k % 16 || (uintptr_t)v % 16)
    return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* bb = static_cast<const __nv_bfloat16*>(key_bias);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (d) {
    case 16: err = launch_d<16>(qq, kk, vv, bb, oo, B, H, T, S, s); break;
    case 32: err = launch_d<32>(qq, kk, vv, bb, oo, B, H, T, S, s); break;
    case 48: err = launch_d<48>(qq, kk, vv, bb, oo, B, H, T, S, s); break;
    case 64: err = launch_d<64>(qq, kk, vv, bb, oo, B, H, T, S, s); break;
    case 80: err = launch_d<80>(qq, kk, vv, bb, oo, B, H, T, S, s); break;
    case 96: err = launch_d<96>(qq, kk, vv, bb, oo, B, H, T, S, s); break;
    case 112: err = launch_d<112>(qq, kk, vv, bb, oo, B, H, T, S, s); break;
    default: err = launch_d<128>(qq, kk, vv, bb, oo, B, H, T, S, s); break;
  }
  return (int)err;
}
