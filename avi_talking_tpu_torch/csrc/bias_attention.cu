// Biased attention forward, fp32, for Hopper (sm_90a): one kernel behind
// the port's two attention kernels.
//
// Replaces two TPU kernels of avi_talking_tpu/ops/pallas/attention.py, both
// computing, for each (batch b, head h),
//
//     out = softmax(q . k^T + bias) . v
//
// with q pre-scaled by the caller and scores in fp32:
//   * fused_keybias_attention (K1, pl.pallas_call of _attn_kernel_keybias):
//     a (B, S) key bias broadcast over heads and query rows, in every
//     wav2vec2 encoder layer (audio/wav2vec2.py); entry
//     avi_keybias_attention_f32;
//   * fused_bias_attention (K3, pl.pallas_call of _attn_kernel): a bias the
//     TPU wrapper materialises to (B, H, T, S) with broadcast_to, here the
//     FaceFormer decoder's (H, T, T) causal ALiBi bias and (T, S) alignment
//     bias (ops/transformer.py::TransformerDecoderLayer); entry
//     avi_bias_attention_f32.
// The kernel reads the bias in place through four element strides
// (b, h, t, s), 0 on every broadcast dimension: K1's key bias is strides
// (S, 0, 0, 1). No (B, H, T, S) bias or score tensor is ever written to
// device memory.
//
// What bounds it: 4*B*H*T*S*d fp32 operations against the bytes of q, k, v,
// out and the bias as stored. At the wav2vec2 shapes (H=12, d=64,
// T=S=64..512) that is about T/4 operations per byte, and at the decoder's
// long shapes (H=4, d=16..32, T=S=600) d/2 to d per bias byte, so the fp32
// (non tensor core) rate bounds it; at T=25 the launch itself dominates.
//
// Design (simple and right first; no wgmma/TMA yet):
//   * one block per (b*h, 64-query tile); K and V stream through shared
//     memory in 64-key tiles;
//   * 256 threads as a 16 x 16 grid, each owning a 4 x 4 micro-tile of the
//     64 x 64 score tile (rows ty+16i, keys tx+16j), so every pair of
//     shared-memory loads feeds 16 FMAs; rows padded to d+1 floats so the
//     strided rows land on distinct banks;
//   * online softmax with running max and sum per row in fp32 registers,
//     reduced over the 16 lanes of a row with warp shuffles; probabilities
//     staged in shared memory for the P.V product, whose fp32 accumulator
//     (4 rows x up to 8 columns per thread) stays in registers;
//   * each thread reads its 16 bias values of a tile straight from device
//     memory: lanes tx of a row read neighbouring keys, so a bias with unit
//     key stride is read coalesced (and K1's, shared by all rows, from L1);
//   * keys past S are excluded outright (probability 0); a key masked by
//     the caller's finite -1e9 bias still counts, so a row whose every bias
//     is -1e9 is a uniform softmax, as on the TPU; query rows past T are
//     computed on zeros with bias 0 and never written.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int RPT = BQ / 16;    // score rows per thread
constexpr int KPT = BK / 16;    // score keys per thread
constexpr int DMAX = 128;       // largest head_dim taken
constexpr int CPT = DMAX / 16;  // output columns per thread, at most

size_t smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) * ((size_t)BQ * ld + 2 * (size_t)BK * ld +
                          (size_t)BQ * (BK + 1));
}

__global__ void __launch_bounds__(THREADS)
bias_attention_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      float* __restrict__ out,
                      int H, int T, int S, int d,
                      long long sb, long long sh, long long st,
                      long long ss) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* q_s = smem;                  // BQ x ld
  float* k_s = q_s + BQ * ld;         // BK x ld
  float* v_s = k_s + BK * ld;         // BK x ld
  float* p_s = v_s + BK * ld;         // BQ x (BK + 1)

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key lane (scores) / column lane (output)
  const int ty = tid >> 4;  // row lane

  const float* qg = q + (size_t)bh * T * d;
  const float* kg = k + (size_t)bh * S * d;
  const float* vg = v + (size_t)bh * S * d;
  const float* bg = bias + b * sb + h * sh;

  for (int e = tid; e < BQ * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    q_s[r * ld + c] = (q0 + r < T) ? qg[(size_t)(q0 + r) * d + c] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's k_s / v_s / p_s reads are done
    for (int e = tid; e < BK * d; e += THREADS) {
      const int r = e / d, c = e - r * d;
      const bool ok = k0 + r < S;
      k_s[r * ld + c] = ok ? kg[(size_t)(k0 + r) * d + c] : 0.f;
      v_s[r * ld + c] = ok ? vg[(size_t)(k0 + r) * d + c] : 0.f;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = k_s[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;
      const float* brow = bg + (long long)row * st;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key < S) {
          s[i][j] += (row < T) ? brow[(long long)key * ss] : 0.f;
        } else {
          s[i][j] = -INFINITY;
        }
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 lanes of a row group differ only in the low 4 lane bits
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int c = tx + 16 * cc;
        if (c < d) {
          const float vv = v_s[j * ld + c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float inv = 1.f / l[i];
    float* og = out + ((size_t)bh * T + row) * d;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = tx + 16 * cc;
      if (c < d) og[c] = acc[i][cc] * inv;
    }
  }
}

int launch(const float* q, const float* k, const float* v, const float* bias,
           float* out, int B, int H, int T, int S, int d, long long sb,
           long long sh, long long st, long long ss, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || d <= 0 || d > DMAX || d % 8 ||
      (long long)B * H > 65535 || sb < 0 || sh < 0 || st < 0 || ss < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bias_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(DMAX));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  bias_attention_kernel<<<grid, THREADS, smem_bytes(d),
                          (cudaStream_t)stream>>>(q, k, v, bias, out, H, T, S,
                                                  d, sb, sh, st, ss);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, H, T, d); k, v: (B, H, S, d); all fp32, contiguous, on the
// current device. Each entry launches on `stream` and returns
// cudaGetLastError() (0 on success); neither synchronises.

// bias is fp32, read at bias[b*sb + h*sh + t*st + s*ss] (element strides,
// 0 on a broadcast dimension).
extern "C" int avi_bias_attention_f32(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      float* out, int B, int H, int T, int S,
                                      int d, long long sb, long long sh,
                                      long long st, long long ss,
                                      void* stream) {
  return launch(q, k, v, bias, out, B, H, T, S, d, sb, sh, st, ss, stream);
}

// key_bias: (B, S) fp32, contiguous, broadcast over heads and query rows.
extern "C" int avi_keybias_attention_f32(const float* q, const float* k,
                                         const float* v, const float* key_bias,
                                         float* out, int B, int H, int T,
                                         int S, int d, void* stream) {
  return launch(q, k, v, key_bias, out, B, H, T, S, d, S, 0, 0, 1, stream);
}
