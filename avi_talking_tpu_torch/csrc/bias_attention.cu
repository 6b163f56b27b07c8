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
//     avi_bias_attention_f32 with the strides (S, 0, 0, 1);
//   * fused_bias_attention (K3, pl.pallas_call of _attn_kernel): a bias the
//     TPU wrapper materialises to (B, H, T, S) with broadcast_to, here the
//     FaceFormer decoder's (H, T, T) causal ALiBi bias and (T, S) alignment
//     bias (ops/transformer.py::TransformerDecoderLayer); entry
//     avi_bias_attention_f32 (a float32 bias) or
//     avi_bias_attention_f32_bias_bf16 (a bfloat16 one).
// The kernel reads the bias in place through four element strides
// (b, h, t, s), 0 on every broadcast dimension: K1's key bias is strides
// (S, 0, 0, 1). No (B, H, T, S) bias or score tensor is ever written to
// device memory.
//
// What bounds it: 4*B*H*T*S*d multiply-adds counted as operations against
// the bytes of q, k, v, out and the bias as stored. At the wav2vec2 shapes
// (H=12, d=64, T=S=200..600) that is about T/4 operations per byte, and at
// the decoder's long shapes (H=4, d=16..32, T=S=600) d/2 to d per bias byte:
// operations bound it at every shape the port runs but the training step's
// (T=25), where the launch does. The exact fp32 arithmetic below costs three
// TF32 tensor-core products per fp32 product, so the least time is
// 3*4*B*H*T*S*d over the TF32 peak. Short of that bound, latency costs: on
// an H100 SXM a dependent m16n8k8 TF32 mma takes about 35-39 cycles, while
// independent ones issue every 7 or so (about 290 TFLOP/s TF32 from
// mma.sync with 8 chains and 16 warps per SM; scripts/torch_mma_probe.py),
// so the design keeps many warps per SM and several chains per warp.
//
// Design:
//   * both products on tensor cores at fp32 accuracy ("3xTF32"):
//     mma.sync m16n8k8 TF32 with fp32 accumulation; each fp32 operand x is
//     split into big = rna_tf32(x) and small = rna_tf32(x - big), and each
//     product is small*big + big*small + big*big (small*small, about 2^-22
//     of the product, is dropped). One-pass TF32 keeps about three decimal
//     digits and is not used. mma.sync rather than wgmma: its 16-row warp
//     tiles let a block hold only 16 query rows;
//   * one block of 4 warps per (16-query tile, b*h): 156 blocks at B=1 H=12
//     T=200 and 152 at B=1 H=4 T=600 for 132 SMs. The block streams K and V
//     in 64-key tiles; warp w takes keys 16w..16w+15 of every tile with its
//     own online softmax (running max m, sum l, accumulator), and the four
//     are merged through shared memory at the end. (Blocks of 32 or 64
//     query rows, which read K and V from L2 half or a quarter as often,
//     were no faster at any of the port's shapes: L2 traffic does not bind.)
//   * one K tile and one V tile in shared memory, filled by cp.async.cg
//     16-byte copies: V(i) is copied while the warps form q . K(i)^T, and
//     K(i+1) while they form p . V(i), so each copy overlaps products with
//     half the shared memory of a two-stage K / V ring; at d <= 64 that lets
//     4 blocks (16 warps) share an SM. Keys past S are zero-filled;
//   * the P.V product takes P straight from the score accumulators: the
//     accumulator gives a thread keys 2t and 2t+1 of its rows, so the key
//     order of the k8 step is permuted (k-slot t <-> key 2t, t+4 <-> 2t+1)
//     and V's rows are read in the same order; q.k^T permutes head-dim
//     columns the same way, so Q and K fragments are 8-byte loads;
//   * the scores' big.big products and their corrections accumulate apart,
//     four independent mma chains per warp instead of two;
//   * row pitches make every fragment load free of bank conflicts: Q and K
//     rows hold 8*odd floats (8-byte loads of 8 rows x 4 lanes), V rows
//     d + 4 = 4*odd (rows 2t, 2t+1 of 8 columns);
//   * q is split once per block into big / small tiles in shared memory;
//   * each thread reads the bias of its own score fragment straight from
//     device memory (keys 2t, 2t+1 of rows g and g+8), issued before the
//     wait for the tile: neighbouring lanes read neighbouring keys when the
//     key stride is 1, and K1's bias, shared by all rows, comes from L1;
//   * keys past S are excluded outright (-inf); a key masked by the caller's
//     finite -1e9 still counts, so a row whose every bias is -1e9 is a
//     uniform softmax, as on the TPU. A warp whose keys all lie past S keeps
//     m = -inf, l = 0 and a zero accumulator: the softmax shifts by 0, not
//     by -inf, so no exp(-inf - -inf) arises. Query rows past T are computed
//     on zeros with bias 0 and never written;
//   * the softmax's exponentials are ex2.approx based (__expf): about 1e-6
//     relative at the scores' range, well inside the 1e-5 gate;
//   * instantiations by head-dim tiles (d <= 16, 32, 64, 128) size the
//     accumulator, and by the bias's type: float32 or bfloat16, read as
//     float32 (the Pallas kernels' bias.astype(float32)); the dynamic
//     shared-memory limit is raised once per device, not per launch;
//   * a block's (query tile, b*h) comes from the grid's x dimension alone,
//     query tiles fastest, so B*H is not held to the y dimension's 65535.
// The head dim is a multiple of 8 here: the wrapper zero-pads q, k and v of
// any other d up to 128 to the next multiple (zero columns add nothing to
// q . k^T, and give zero output columns, which it drops).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16;            // query rows per block, one mma row tile
constexpr int BK = 16 * WARPS;    // keys per K / V tile, 16 per warp
constexpr int DMAX = 128;         // largest head_dim taken
constexpr int MAX_DEVICES = 64;

// Row pitches in floats. Q / K: 8 * odd, so 8-byte loads of rows g (8 of
// them) at columns 2t (4 lanes) fill 32 distinct banks per half-warp.
// V: d + 4 = 4 * odd, so rows 2t (4 lanes) at columns g (8 lanes) do.
__host__ __device__ inline int pitch_qk(int d) {
  const int n = d / 8;
  return 8 * ((n % 2 == 0) ? n + 1 : n + 2);
}
__host__ __device__ inline int pitch_v(int d) { return d + 4; }

size_t smem_bytes(int d) {
  const size_t qk = pitch_qk(d), pv = pitch_v(d);
  return sizeof(float) * (2 * BQ * qk           // q big, q small
                          + (size_t)BK * qk      // K tile
                          + (size_t)BK * pv      // V tile
                          + 2 * WARPS * BQ       // per-warp m, l
                          + 2 * BQ);             // merged m, l
}

// x rounded to TF32, to nearest with ties away from zero: the result of
// cvt.rna.tf32.f32 for every finite x, in two integer operations (the whole
// kernel 5-10% faster than with the cvt instruction on an H100 SXM;
// scripts/torch_attention_variants.py, variant "cvt").
__device__ __forceinline__ uint32_t tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A bias element as float32, whatever its stored type.
__device__ __forceinline__ float bias_f32(const float* p) { return *p; }
__device__ __forceinline__ float bias_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_big(x);
  small = tf32_big(x - __uint_as_float(big));
}

// c += a . b, m16n8k8, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copies rows k0..k0+BK-1 of a (S, d) matrix into a tile of row pitch
// `pitch`; rows past S become 0. The row of chunk e is e / chunks, taken
// through a float reciprocal (exact here: e < 2048, chunks <= 32).
__device__ __forceinline__ void stage_rows(float* dst, int pitch, const float* src, int k0,
                                           int S, int d, int tid) {
  const int chunks = d / 4;
  const float inv = 1.f / chunks;
  for (int e = tid; e < BK * chunks; e += THREADS) {
    const int r = __float2int_rz((e + 0.5f) * inv), c = 4 * (e - r * chunks);
    const bool ok = k0 + r < S;
    cp_async16(dst + r * pitch + c, src + (ok ? (size_t)(k0 + r) * d + c : 0), ok);
  }
}

// Softmax state of one warp's 16 query rows over the keys it has seen: a
// thread holds rows g (m0, l0, acc[n][0..1]) and g + 8 (m1, l1,
// acc[n][2..3]), columns 8n + 2t and 8n + 2t + 1.
template <int NT>
struct RowState {
  float m0, m1, l0, l1;
  float acc[NT][4];
};

// The block's 16 query rows (q_b / q_s: their big / small halves) against a
// warp's 16 keys (k_s: their rows) with the bias of its score fragment (bv,
// -inf past S): the scores, the online-softmax update of st (acc rescaled)
// and the probabilities p, in the score fragment's layout.
template <int NT>
__device__ __forceinline__ void scores16(const float* q_b, const float* q_s,
                                         const float* k_s, int qk, int nd, int g, int t,
                                         const float (&bv)[2][4], RowState<NT>& st,
                                         float (&p)[2][4]) {
  // s = q . k^T over two n8 key tiles; k-slot t of a k8 step is head-dim
  // column 2t, slot t + 4 is column 2t + 1. big.big and the two corrections
  // accumulate apart: four independent chains.
  float sb[2][4] = {}, sc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (kk >= nd) break;
    const int c = 8 * kk + 2 * t;
    const float2 b0 = *reinterpret_cast<const float2*>(q_b + g * qk + c);
    const float2 b1 = *reinterpret_cast<const float2*>(q_b + (g + 8) * qk + c);
    const float2 s0 = *reinterpret_cast<const float2*>(q_s + g * qk + c);
    const float2 s1 = *reinterpret_cast<const float2*>(q_s + (g + 8) * qk + c);
    const uint32_t ab[4] = {__float_as_uint(b0.x), __float_as_uint(b1.x),
                            __float_as_uint(b0.y), __float_as_uint(b1.y)};
    const uint32_t as[4] = {__float_as_uint(s0.x), __float_as_uint(s1.x),
                            __float_as_uint(s0.y), __float_as_uint(s1.y)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 kx = *reinterpret_cast<const float2*>(k_s + (8 * j + g) * qk + c);
      uint32_t bb0, bs0, bb1, bs1;
      split(kx.x, bb0, bs0);
      split(kx.y, bb1, bs1);
      mma_tf32(sc[j], as, bb0, bb1);
      mma_tf32(sc[j], ab, bs0, bs1);
      mma_tf32(sb[j], ab, bb0, bb1);
    }
  }

  // online softmax over the 4 lanes of a row group
  float s[2][4];
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = (sc[j][i] + sb[j][i]) + bv[j][i];
    t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
    t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, o));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, o));
  }
  const float n0 = fmaxf(st.m0, t0), n1 = fmaxf(st.m1, t1);
  const float z0 = n0 == -INFINITY ? 0.f : n0;  // no key of this warp yet
  const float z1 = n1 == -INFINITY ? 0.f : n1;
  const float alpha0 = __expf(st.m0 - z0), alpha1 = __expf(st.m1 - z1);
  st.m0 = n0;
  st.m1 = n1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    p[j][0] = __expf(s[j][0] - z0);
    p[j][1] = __expf(s[j][1] - z0);
    p[j][2] = __expf(s[j][2] - z1);
    p[j][3] = __expf(s[j][3] - z1);
  }
  st.l0 = st.l0 * alpha0 + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
  st.l1 = st.l1 * alpha1 + (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    st.acc[n][0] *= alpha0;
    st.acc[n][1] *= alpha0;
    st.acc[n][2] *= alpha1;
    st.acc[n][3] *= alpha1;
  }
}

// acc += p . v over a warp's 16 keys (v_s: their rows); k-slot t of step j
// is key 8j + 2t, slot t + 4 key 8j + 2t + 1, as the score fragment holds
// them.
template <int NT>
__device__ __forceinline__ void accumulate16(const float (&p)[2][4], const float* v_s, int pv,
                                             int nd, int g, int t, RowState<NT>& st) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t ab[4], as[4];
    split(p[j][0], ab[0], as[0]);
    split(p[j][2], ab[1], as[1]);
    split(p[j][1], ab[2], as[2]);
    split(p[j][3], ab[3], as[3]);
    const float* v0 = v_s + (8 * j + 2 * t) * pv + g;
    const float* v1 = v0 + pv;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nd) {
        uint32_t bb0, bs0, bb1, bs1;
        split(v0[8 * n], bb0, bs0);
        split(v1[8 * n], bb1, bs1);
        mma_tf32(st.acc[n], as, bb0, bb1);
        mma_tf32(st.acc[n], ab, bs0, bs1);
        mma_tf32(st.acc[n], ab, bb0, bb1);
      }
    }
  }
}

// NT: head-dim tiles of 8 held in the accumulator (d <= 8 * NT); BT: the
// bias's stored type. The register budget is sized for 4 blocks per SM
// where the shared memory allows 4 (d <= 64), else for 2.
template <int NT, typename BT>
__global__ void __launch_bounds__(THREADS, NT <= 8 ? 4 : 2)
bias_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const BT* __restrict__ bias,
                      float* __restrict__ out, int H, int T, int S, int d,
                      long long sb, long long sh, long long st, long long ss) {
  extern __shared__ __align__(16) float smem[];
  const int qk = pitch_qk(d), pv = pitch_v(d);
  float* qb_s = smem;                 // BQ x qk, big halves of q
  float* qs_s = qb_s + BQ * qk;       // BQ x qk, small halves
  float* k_s = qs_s + BQ * qk;        // BK x qk
  float* v_s = k_s + BK * qk;         // BK x pv
  float* m_s = v_s + BK * pv;         // WARPS x BQ
  float* l_s = m_s + WARPS * BQ;      // WARPS x BQ
  float* mm_s = l_s + WARPS * BQ;     // BQ merged max
  float* ll_s = mm_s + BQ;            // BQ merged sum

  const int nq = (T + BQ - 1) / BQ;  // query tiles of one (b, h)
  const int bh = blockIdx.x / nq;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (blockIdx.x - bh * nq) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / lane in group
  const int nd = d / 8;

  const float* qg = q + (size_t)bh * T * d;
  const float* kg = k + (size_t)bh * S * d;
  const float* vg = v + (size_t)bh * S * d;
  const BT* bg = bias + b * sb + h * sh;

  const int nk = (S + BK - 1) / BK;
  stage_rows(k_s, qk, kg, 0, S, d, tid);
  cp_async_commit();

  for (int e = tid; e < BQ * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    uint32_t big, small;
    split(q0 + r < T ? qg[(size_t)(q0 + r) * d + c] : 0.f, big, small);
    qb_s[r * qk + c] = __uint_as_float(big);
    qs_s[r * qk + c] = __uint_as_float(small);
  }

  // rows g and g + 8 of the tile; a row past T reads bias 0
  const int row0 = q0 + g, row1 = q0 + g + 8;
  const BT* brow0 = bg + (long long)min(row0, T - 1) * st;
  const BT* brow1 = bg + (long long)min(row1, T - 1) * st;

  RowState<NT> rs;
  rs.m0 = rs.m1 = -INFINITY;
  rs.l0 = rs.l1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) rs.acc[n][i] = 0.f;

  // K(it) was copied during P.V of tile it - 1; V(it) is copied during
  // q . K(it)^T. Commit groups in flight: K(it), then V(it), then K(it+1).
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * BK;
    stage_rows(v_s, pv, vg, k0, S, d, tid);  // the previous P.V is done (sync below)
    cp_async_commit();

    // the bias of this warp's keys k0 + 16 warp + 8 j + 2 t + {0, 1}
    float bv[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 16 * warp + 8 * j + 2 * t + e;
        const bool ok = key < S;
        bv[j][e] = !ok ? -INFINITY : (row0 < T ? bias_f32(brow0 + (long long)key * ss) : 0.f);
        bv[j][2 + e] = !ok ? -INFINITY : (row1 < T ? bias_f32(brow1 + (long long)key * ss) : 0.f);
      }

    cp_async_wait<1>();
    __syncthreads();  // K(it) (and, on the first tile, q) is in place
    float p[2][4];
    scores16<NT>(qb_s, qs_s, k_s + 16 * warp * qk, qk, nd, g, t, bv, rs, p);
    __syncthreads();  // every warp is done with K(it)
    if (it + 1 < nk) stage_rows(k_s, qk, kg, k0 + BK, S, d, tid);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();
    __syncthreads();  // V(it) is in place
    accumulate16<NT>(p, v_s + 16 * warp * pv, pv, nd, g, t, rs);
    __syncthreads();  // every warp is done with V(it)
  }

  // merge the four warps' (m, l, acc) of each row
  float l0 = rs.l0, l1 = rs.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {
    m_s[warp * BQ + g] = rs.m0;
    m_s[warp * BQ + g + 8] = rs.m1;
    l_s[warp * BQ + g] = l0;
    l_s[warp * BQ + g + 8] = l1;
  }
  __syncthreads();
  if (tid < BQ) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w * BQ + tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += l_s[w * BQ + tid] * __expf(m_s[w * BQ + tid] - mx);
    mm_s[tid] = mx;  // finite: warp 0 always holds key 0
    ll_s[tid] = sum;
  }
  __syncthreads();
  const float f0 = __expf(rs.m0 - mm_s[g]);  // 0 for a warp that saw no key
  const float f1 = __expf(rs.m1 - mm_s[g + 8]);
  float* red = k_s + warp * BQ * qk;  // WARPS x BQ x qk, in the K buffer
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nd) {
      const int c = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(red + g * qk + c) =
          make_float2(rs.acc[n][0] * f0, rs.acc[n][1] * f0);
      *reinterpret_cast<float2*>(red + (g + 8) * qk + c) =
          make_float2(rs.acc[n][2] * f1, rs.acc[n][3] * f1);
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    if (q0 + r >= T) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += k_s[(w * BQ + r) * qk + c];
    out[((size_t)bh * T + q0 + r) * d + c] = sum / ll_s[r];
  }
}

// Read once per device: 0 until set, then 1 + the setter's cudaError_t.
// Two threads racing to set it both store the same value, which is harmless.
template <int NT, typename BT>
cudaError_t raise_smem_limit(int dev) {
  static std::atomic<int> state[MAX_DEVICES];
  int val = state[dev].load(std::memory_order_acquire);
  if (val == 0) {
    val = 1 + (int)cudaFuncSetAttribute(bias_attention_kernel<NT, BT>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem_bytes(8 * NT));
    state[dev].store(val, std::memory_order_release);
  }
  return (cudaError_t)(val - 1);
}

template <int NT, typename BT>
cudaError_t launch_nt(const float* q, const float* k, const float* v, const BT* bias,
                      float* out, int B, int H, int T, int S, int d, long long sb,
                      long long sh, long long st, long long ss, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  err = raise_smem_limit<NT, BT>(dev);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((T + BQ - 1) / BQ) * (unsigned)(B * H);
  bias_attention_kernel<NT, BT><<<grid, THREADS, smem_bytes(d), stream>>>(
      q, k, v, bias, out, H, T, S, d, sb, sh, st, ss);
  return cudaGetLastError();
}

template <typename BT>
int launch(const float* q, const float* k, const float* v, const BT* bias, float* out,
           int B, int H, int T, int S, int d, long long sb, long long sh, long long st,
           long long ss, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || d <= 0 || d > DMAX || d % 8 ||
      (long long)B * H * ((T + BQ - 1) / BQ) > INT_MAX || sb < 0 || sh < 0 || st < 0 ||
      ss < 0 || (uintptr_t)k % 16 || (uintptr_t)v % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (d <= 16)
    err = launch_nt<2>(q, k, v, bias, out, B, H, T, S, d, sb, sh, st, ss, s);
  else if (d <= 32)
    err = launch_nt<4>(q, k, v, bias, out, B, H, T, S, d, sb, sh, st, ss, s);
  else if (d <= 64)
    err = launch_nt<8>(q, k, v, bias, out, B, H, T, S, d, sb, sh, st, ss, s);
  else
    err = launch_nt<16>(q, k, v, bias, out, B, H, T, S, d, sb, sh, st, ss, s);
  return (int)err;
}

}  // namespace

// q, out: (B, H, T, d); k, v: (B, H, S, d), 16-byte aligned; all fp32,
// contiguous, on the current device; d a multiple of 8 up to 128. Each
// entry launches on `stream` and returns the launch's cudaError_t (0 on
// success); none synchronises.

// bias is fp32, read at bias[b*sb + h*sh + t*st + s*ss] (element strides,
// 0 on a broadcast dimension). K1 is this entry with strides (S, 0, 0, 1).
extern "C" int avi_bias_attention_f32(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      float* out, int B, int H, int T, int S,
                                      int d, long long sb, long long sh,
                                      long long st, long long ss,
                                      void* stream) {
  return launch(q, k, v, bias, out, B, H, T, S, d, sb, sh, st, ss, stream);
}

// The same with a bfloat16 bias.
extern "C" int avi_bias_attention_f32_bias_bf16(const float* q, const float* k,
                                                const float* v, const void* bias,
                                                float* out, int B, int H, int T, int S,
                                                int d, long long sb, long long sh,
                                                long long st, long long ss,
                                                void* stream) {
  return launch(q, k, v, static_cast<const __nv_bfloat16*>(bias), out, B, H, T, S, d, sb, sh,
                st, ss, stream);
}

// key_bias: (B, S) fp32, contiguous, broadcast over heads and query rows
// (the measurement scripts under scripts/ bind this entry).
extern "C" int avi_keybias_attention_f32(const float* q, const float* k,
                                         const float* v, const float* key_bias,
                                         float* out, int B, int H, int T,
                                         int S, int d, void* stream) {
  return launch(q, k, v, key_bias, out, B, H, T, S, d, S, 0, 0, 1, stream);
}
