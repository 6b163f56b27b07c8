// Biased attention forward on bfloat16 inputs, for Hopper (sm_90a): one
// kernel behind the bfloat16 entries of the port's two attention kernels.
//
// Replaces two TPU kernels of avi_talking_tpu/ops/pallas/attention.py on
// bfloat16 q, k and v:
//   * K1, fused_keybias_attention (pl.pallas_call of _attn_kernel_keybias),
//     where the JAX package's --bf16 mode runs it: every wav2vec2 encoder
//     layer of the product path (audio/wav2vec2.py), a (B, S) key bias read
//     through the strides (S, 0, 0, 1);
//   * K3, fused_bias_attention (pl.pallas_call of _attn_kernel), where the
//     FaceFormer family runs at bfloat16 compute: the decoder's (H, T, T)
//     ALiBi bias and (T, S) alignment bias (ops/transformer.py), read in
//     place through four element strides (b, h, t, s), 0 on a broadcast
//     dimension, as bias_attention.cu reads it at float32.
// For each (batch b, head h):
//
//     out = bf16( P . V ),  P = bf16( exp(s - m) / l ),  s = q . k^T + bias
//
// with q pre-scaled by the caller, the bias (float32 or bfloat16, a template
// parameter) read as fp32, s and the softmax in fp32, P rounded to bfloat16
// (the Pallas kernels' weights.astype(v.dtype)) after it is normalised, P . V
// accumulated in fp32 and the output rounded to bfloat16 (round to nearest
// even, as torch's .to(torch.bfloat16)). The float32 entries stay in
// bias_attention.cu. The head dim is a multiple of 16 here: the wrapper
// zero-pads any other d up to 128 to the next multiple (zero columns add
// nothing to q . k^T and give zero output columns, which it drops), so the
// full-width configurations' d = 16, 32 and 64 take no copy.
//
// What bounds it: 4*B*H*T*S*d operations (the two products) against the
// bytes of q, k, v and out in bfloat16 and of the bias as it is stored. K1:
// T/2 operations per byte at T = S, under the H100's bf16 ridge of about 295
// up to T of about 590; a launch at the generate shapes is well under a
// microsecond of work (0.37 us of bytes at B=1 H=12 T=S=200 d=64). K3 at the
// FaceFormer decoder's shape (B=1 H=4 T=S=600 d=32): the float32 (H, T, T)
// bias is 5.76 MB against 0.46 MB of q, k and v and 0.15 MB of out, 6.38 MB
// in all, 1.9 us at 3.35 TB/s, while its 184 MFLOP take 0.19 us at 989
// TFLOP/s: the bias's bytes bound it, at about 1 operation per byte. What
// the design does about them: the bias goes through shared memory, and each
// element of it leaves device memory once per block where it fits. A bias
// of one row per (b, h) (st = 0: K1's key bias) is staged in fp32 at the
// block's set-up, by a kernel compiled apart (kStaged) that carries no other
// bias code. Any other is kept as stored: whole (the block's rows x every
// key, 41 KB a 16-row group at S = 600 in fp32) beside resident K and V,
// serving both passes (the softmax's statistics, then P . V), or, where
// that does not fit, in ring slots with K's tiles as K and V stream.
// pick_groups counts its bytes: at the decoder's shape a block holds 2 row
// groups, 76 blocks, one per SM. A whole bias with adjacent keys and rows
// S to 64 * tiles keys apart (every layout the decoders give it) comes in
// the block's set-up as one span of device memory, the block's rows with
// the gaps between them: its 16-byte-aligned middle by one bulk copy of
// the async copy unit, issued by one thread as soon as the barriers are
// set up and counted by the first copy group's barrier, its ragged ends
// (under 16 bytes) by plain loads, the span shifted in shared memory by its
// address's offset from a 16-byte boundary. One copy a block: a bulk copy
// a row cost about 100 cycles of the copy unit each, and at B=16 T=25 the
// rows' 16 copies took 2,200 cycles to land, where the earlier version's
// one trip to the bias took 700. Any other bias goes tile by tile in the
// copy group of each K tile, in rows padded so that rows g and g + 8 fall
// in distinct banks, by cp.async of 16 bytes, 4 or a plain load
// (copy_chunk). Each consumer thread reads its fragment (rows g and g + 8,
// keys 2t and 2t + 1 of each 8-key tile) key by key from shared memory
// after the chunk's products. Read from device memory by the consumers
// themselves, as an earlier version did, the bias cost each warp two
// dependent trips a tile in each pass, 20 at T = 600, with one block of 4
// consumer warps on most SMs to hide them; copied tile by tile with K by
// cp.async, it ran no faster: an SM takes cp.async copies at about 7 bytes
// a cycle, and a block's K, V and bias (154 KB) took that long. The bulk
// copy goes beside them. A launch at these shapes is a few microseconds of
// work either way, so latency, the grid and the launch count matter too.
//
// Design. The first version (one 4-warp block per 64 query rows, every warp
// walking every key, K read twice through synchronous tile copies, expf and
// a division per score, scalar loads of V) left four things in the way;
// what this one does about each:
//
//   * The grid filled a third of the card (48 blocks on 132 SMs at the
//     generate shape). A block now holds 1 to 4 row groups of 16 query rows
//     (2 above d = 64, for the registers), each of 4 consumer warps that
//     split the keys between them, and the host takes the groups that give
//     the fewest waves of blocks, each block weighted by its rows plus what
//     its set-up costs (pick_groups): 156 blocks of 16 rows at B=1 H=12
//     T=200, 252 of 16 at T=333, 264 of 48 at B=2 T=512 and 120 of 64 at
//     T=600; K3 76 of 32 at B=1 H=4 T=600. More rows a block read K, V and
//     the bias fewer times.
//   * K was read from device memory twice and every copy waited. K and V of the
//     (b, h) now go into dynamic shared memory once per block, in 64-key tiles,
//     by PRODUCERS producer warps beside the consumers: q with K's first tile,
//     K's other tiles, then V's, one cp.async group each (16 bytes a lane, L2
//     only), two groups ahead of the one released; each tile's mbarrier takes
//     the producers' arrivals once its group has landed (cp.async.wait_group),
//     and a consumer waits on the tile it reads and on nothing else. A warp
//     that issues copies stalls until the SM takes them, at about the rate they
//     land (10 to 20 bytes a cycle on the H100), so the copies come from warps
//     that do nothing else, while the consumers start on the first tiles; the
//     first two groups go out before the block's set-up barrier. Rows are
//     padded to d + 8 bfloat16, so the ldmatrix reads of 8 rows fall in
//     distinct banks. The blocks of one (b, h) start on different tiles, so
//     that they do not ask L2 for the same lines at once. When K and V do not
//     fit with the bias (4*S*(d+8) bytes and the bias staged or kept whole
//     past the 227 KB a block may take; at 16 rows, with the key bias d=128
//     from S = 401 and d=64 from 785, with a float32 bias kept whole 369 and
//     641) they stream through rings of RING tiles each instead, a bias not
//     staged with K: pass 1 reads K, pass 2 K again with V, and a slot is
//     refilled once every consumer warp has arrived on its empty barrier.
//   * Each warp walked every key. Keys are now dealt to the 4 consumer
//     warps of a row group in 16-key chunks (chunk c to warp c % 4, so all
//     four work on every tile as it lands). Pass 1: each warp keeps its
//     rows' max m and sum l over its own keys; the group merges them
//     through shared memory, M = max m_w and L = sum_w l_w exp(m_w - M)
//     (warps in order). Pass 2: each warp forms P = bf16(exp(s - M) * (1 /
//     L)) for its keys and accumulates P . V in fp32; the four partial sums
//     are added in fp32 through shared memory (warps in order, into the
//     space K and V held) before the one bf16 rounding of the output.
//   * The inner loops are cheaper: exp as ex2 of (s - m) * log2(e), the
//     reciprocal of L taken once per row, the bias in shared memory, q's A
//     fragments and K's B fragments by ldmatrix and V's
//     by ldmatrix.trans from shared memory (one instruction per 8x8 pair of
//     operands instead of scalar loads). These move P's fp32 value by a few
//     ulp, well inside the 2^-20 relative differences kb.bf16_disagreement's
//     limit is derived from; tests/test_torch_bf16.py emulates this order
//     and these rounding points on the CPU and holds them to that limit.
//
// The normalisation stays before P is rounded, hence the two passes: a
// one-pass online softmax would round the unnormalised exponentials, another
// quantity. Keys past S are excluded (-inf); a key masked by the caller's
// finite bias still counts, so a row whose every bias is the bf16 -1e9 is a
// uniform softmax, as on the TPU. Rows past T are computed on zeros and
// never written; K and V rows past S that a chunk reads are zeros or an
// earlier tile's finite values, weighted by P = 0.
//
// Tensor cores: mma.sync m16n8k16, bfloat16 operands (their products exact
// in fp32) with fp32 accumulation. wgmma needs 64-row tiles per warpgroup,
// which at T=200 leaves 48 blocks again; at these shapes both products take
// well under a microsecond of tensor-core time, so the grid, the copies and
// the latency of each warp's steps matter and the rate does not. P is taken
// straight from the score accumulators: for m16n8k16 the accumulator of key
// columns 2t, 2t+1 of an 8-key tile is the A fragment's layout, two 8-key
// tiles making one 16-key k step. Instantiations for d = 16, 32, ..., 128
// (a multiple of 16; wav2vec2's is 64, the decoders' 32 and 16), for a
// float32 or bfloat16 bias, each for a staged bias and for any other (32
// kernels, two of half the code where one held both); __launch_bounds__ of the largest block and 1
// block per SM, so ptxas may take the registers it needs and does not
// spill. A block's (query tile, b*h) comes from the grid's x dimension
// alone, query tiles fastest, so B*H is not held to the y dimension's 65535.
//
// Keys whose bias is -inf (past S, or the caller's) weigh 0: a warp that has
// seen only such keys of a row keeps m = -inf and l = 0 and shifts by 0, so
// no exp(-inf - -inf) arises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>

namespace {

constexpr int SHARES = 4;         // consumer warps of a row group, each with a share of the keys
constexpr int BK = 16 * SHARES;   // keys per tile: one 16-key chunk per consumer warp
constexpr int DMAX = 128;
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_MAX = 232448;  // the 227 KB a block may take on sm_90
constexpr int RING = 4;           // tiles of K and of V held at once when they do not fit
constexpr int PRODUCERS = 4;      // warps that issue the copies
constexpr int LAG = 2;            // copy groups the producers keep in flight past a released one
constexpr int PRE = 2;            // copy groups the producers issue before the set-up barrier
static_assert(PRE <= LAG && LAG <= RING - 1, "group 0 is released once group LAG goes out");
constexpr int BP = BK + 8;        // a bias ring slot's row pitch (rows g, g + 8: other banks)
constexpr float LOG2E = 1.4426950408889634f;

// Row groups of 16 query rows a block may hold (4 only up to d = 64, where
// the registers allow them).
template <int D>
constexpr int max_groups() {
  return D <= 64 ? 4 : 2;
}

// The row pitch (elements) of a bias kept whole and copied tile by tile:
// every tile's 64 keys and 8 more, so that rows g and g + 8 fall in
// distinct banks; the room it takes also holds a span (span_of).
__host__ __device__ inline int whole_pitch(int tiles) { return tiles * BK + 8; }

// Byte offsets of a block's dynamic shared memory: the mbarriers (resident:
// one per copy group, full; streamed: RING full and RING empty), each row
// group's (m, l) per consumer warp and row, the bias (`staged`: one row in
// fp32; else as stored, `esize` bytes an element: kept whole when K and V
// are resident, in RING one-tile slots when they stream), the q rows, K, V.
// After pass 2 the K / V space holds the warps' partial sums. K and V are
// resident (every tile, S rounded up to 16 rows) or stream through rings of
// RING 64-row tiles each.
struct Plan {
  size_t stats, bias, q, k, v, bytes;
};

template <int D>
__host__ __device__ inline Plan plan(int S, int groups, bool resident, bool staged, int esize) {
  constexpr size_t P = D + 8;
  const int tiles = (S + BK - 1) / BK;
  const size_t s16 = (size_t)(S + 15) / 16 * 16;
  const size_t rows = resident ? s16 : (size_t)RING * BK;
  const size_t qrows = (size_t)16 * groups;
  const size_t bias = staged     ? s16 * sizeof(float)
                      : resident ? qrows * whole_pitch(tiles) * esize
                                 : (size_t)RING * qrows * BP * esize;
  Plan p;
  p.stats = ((size_t)(resident ? 2 * tiles : 2 * RING) * 8 + 15) / 16 * 16;
  p.bias = p.stats + (size_t)groups * SHARES * 16 * sizeof(float2);
  p.q = p.bias + (bias + 15) / 16 * 16;
  p.k = p.q + (size_t)16 * groups * P * 2;
  p.v = p.k + rows * P * 2;
  const size_t kv_end = p.v + rows * P * 2;
  const size_t part_end = p.k + (size_t)groups * SHARES * (D / 8) * 32 * sizeof(float4);
  p.bytes = kv_end > part_end ? kv_end : part_end;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The same, reading only the first n bytes of src and zero-filling the rest.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4_n(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

// n bytes (a multiple of 16; src and dst 16-byte aligned) by the async copy
// unit, which reports them to `bar` as they land (the barrier's phase waits
// for them once mbar_expect_tx has counted them in).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(n), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Until at most n (up to RING - 1, the largest lag) of this thread's copy
// groups are in flight.
template <int N = RING - 1>
__device__ __forceinline__ void cp_async_wait(int n) {
  if constexpr (N > 0) {
    if (n < N) return cp_async_wait<N - 1>(n);
  }
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Synchronises the consumer warps only (the producer warps do not take it).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// exp(x - m) as the kernel forms it everywhere: 2^y of the fp32 product
// y = (x - m) * log2(e), by the special-function unit (results below 2^-126
// flush to 0: a weight that small moves no bfloat16 output).
__device__ __forceinline__ float exp_from(float x, float m) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"((x - m) * LOG2E));
  return r;
}

// Rows 0..n-1 of a (., D) bfloat16 matrix into rows of D + 8, by the lanes
// of the producer warps (lane: 0 .. 32 * PRODUCERS - 1), 16 bytes a copy.
template <int D>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int n,
                                          int lane) {
  for (int e = lane; e < n * (D / 8); e += 32 * PRODUCERS) {
    const int r = e / (D / 8), c = e - r * (D / 8);
    cp_async16(dst + r * (D + 8) + 8 * c, src + (size_t)r * D + 8 * c);
  }
}

// A bias element as float32, whatever its stored type.
__device__ __forceinline__ float bias_f32(const float* p) { return *p; }
__device__ __forceinline__ float bias_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The bytes a producer lane copies of the bias at once (copy_bias): 16 where
// the keys are adjacent and every row starts on a 16-byte boundary; else 4
// where that holds whole keys (a float32 key anywhere; two adjacent bfloat16
// keys on a 4-byte boundary); else 0, a plain load of each key.
template <typename BT>
__device__ __forceinline__ int copy_chunk(const BT* p, long long sb, long long sh, long long st,
                                          long long ss) {
  constexpr long long e = sizeof(BT);
  auto rows_on = [&](long long a) {
    return (uintptr_t)p % a == 0 && sb * e % a == 0 && sh * e % a == 0 && st * e % a == 0;
  };
  if (ss == 1 && rows_on(16)) return 16;
  if (e == 4 ? rows_on(4) : ss == 1 && rows_on(4)) return 4;
  return 0;
}

// Rows 0..rows-1 of one tile of the bias, keys 0..keys-1 (row r's key c at
// src[r * st + c * ss]), into rows of `pitch` elements as stored, by the
// lanes of the producer warps, `chunk` bytes a copy (copy_chunk). A copy
// that reaches past key `keys` reads the keys before it and zero-fills the
// rest.
template <typename BT>
__device__ __forceinline__ void copy_bias(BT* dst, int pitch, const BT* src, long long st, int ss,
                                          int rows, int keys, int chunk, int lane) {
  const int per = chunk ? chunk / (int)sizeof(BT) : 1;  // keys a copy
  const int n = (keys + per - 1) / per;                  // copies a row
  for (int e = lane; e < rows * n; e += 32 * PRODUCERS) {
    const int r = e / n, c = (e - r * n) * per;
    BT* d = dst + r * pitch + c;
    const BT* from = src + r * st + c * ss;
    const int bytes = min(per, keys - c) * (int)sizeof(BT);
    if (chunk == 16)
      cp_async16_n(d, from, bytes);
    else if (chunk == 4)
      cp_async4_n(d, from, bytes);
    else
      *d = *from;
  }
}

// A block's rows of a bias kept whole, as one span of device memory when
// its keys are adjacent and its rows S to 64 * tiles keys apart (every
// layout the decoders give it): bytes [a, a + n) from the first row's
// first key to the last row's last, the gaps between rows included. Its
// middle [lo, hi), from its first 16-byte boundary to its last, goes by one
// bulk copy (none when lo = hi), its ends (under 16 bytes each) by plain
// loads. In shared memory the span lies a % 16 bytes into its place, so
// that the middle lands on a 16-byte boundary there too.
struct Span {
  uintptr_t a, lo, hi;
};

__device__ __forceinline__ Span span_of(const void* first, int n) {
  const uintptr_t a = (uintptr_t)first, end = a + n;
  uintptr_t lo = (a + 15) & ~(uintptr_t)15, hi = end & ~(uintptr_t)15;
  if (hi < lo) lo = hi = end;  // no boundary inside: all of it is the first end
  return {a, lo, hi};
}

// s[j] = q . K^T for the warp's 16 rows and keys key0 + 8j .. + 7 (k_c: the
// chunk's first K row in shared memory), plus the bias from shared memory:
// the staged row (fp32, -inf past S) when kStaged, else `bt`, the thread's
// row g at the chunk's key 2t (row g + 8's at bt + off8), read key by key
// (a span lies at any element's offset); keys past S are -inf. The bias
// is read after the products: read before them, it held 8 more registers
// across them, and the d = 128 instantiations spilled.
template <int D, bool kStaged, typename BT>
__device__ __forceinline__ void scores(float (&s)[2][4], const uint32_t (&qf)[D / 16][4],
                                       const __nv_bfloat16* k_c, const float* staged,
                                       const BT* bt, int off8, int key0, int S, int lane) {
  // ldmatrix x4: keys 0-7 / dims 0-7, keys 0-7 / dims 8-15, keys 8-15 / ...
  const __nv_bfloat16* kaddr =
      k_c + ((lane & 7) + 8 * (lane >> 4)) * (D + 8) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, kaddr + 16 * kk);
    mma_bf16(s[0], qf[kk], b[0], b[1]);
    mma_bf16(s[1], qf[kk], b[2], b[3]);
  }
  // K rows past S are zeros or an earlier tile's finite values, so s + -inf
  // is -inf there. s[j][0..1] are keys 2t, 2t + 1 of row g, s[j][2..3] of
  // row g + 8.
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = key0 + 8 * j + 2 * t;
    if constexpr (kStaged) {
      const float2 b = *reinterpret_cast<const float2*>(staged + key);
      s[j][0] += b.x;
      s[j][1] += b.y;
      s[j][2] += b.x;
      s[j][3] += b.y;
    } else {
      const BT* p = bt + 8 * j;
      const bool in0 = key < S, in1 = key + 1 < S;
      s[j][0] += in0 ? bias_f32(p) : -INFINITY;
      s[j][1] += in1 ? bias_f32(p + 1) : -INFINITY;
      s[j][2] += in0 ? bias_f32(p + off8) : -INFINITY;
      s[j][3] += in1 ? bias_f32(p + off8 + 1) : -INFINITY;
    }
  }
}

// BT: the bias's stored type (float or bfloat16); the bias is read at
// bias[b*sb + h*sh + t*st + s*ss]. kStaged: it is one row per (b, h) (st =
// 0), staged in fp32 at the block's set-up; else it is kept whole as stored
// when K and V are resident, and rides in ring slots with K when they
// stream.
template <int D, typename BT, bool kStaged>
__global__ void __launch_bounds__(32 * (SHARES * max_groups<D>() + PRODUCERS), 1)
    keybias_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const BT* __restrict__ bias, long long sb, long long sh,
                                  long long st, long long ss,
                                  __nv_bfloat16* __restrict__ out, int H, int T, int S,
                                  bool resident) {
  constexpr int P = D + 8;
  constexpr int NT = D / 8;  // 8-column output tiles
  extern __shared__ __align__(16) unsigned char smem[];

  const int groups = (blockDim.x - 32 * PRODUCERS) / (32 * SHARES);
  const int consumers = 32 * SHARES * groups;
  const int tiles = (S + BK - 1) / BK;
  const Plan pl = plan<D>(S, groups, resident, kStaged, sizeof(BT));
  // Resident: full[g] for copy group g (K's entry g, then V's entry g -
  // tiles). Streamed: full[g % RING] and empty[g % RING], once a lap.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + RING;
  float2* stats = reinterpret_cast<float2*>(smem + pl.stats);
  float* bias_s = reinterpret_cast<float*>(smem + pl.bias);  // staged
  BT* bias_t = reinterpret_cast<BT*>(smem + pl.bias);        // kept whole or ringed
  const int slot_elems = 16 * groups * BP;  // a ring slot
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + pl.q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + pl.k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + pl.v);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // (query tile, b*h) from the grid's x dimension alone, query tiles fastest
  const int nq = (T + 16 * groups - 1) / (16 * groups);
  const int bh = blockIdx.x / nq, qt = blockIdx.x - bh * nq, b = bh / H, h = bh - b * H;
  const int q0 = qt * 16 * groups;
  const int qrows = min(16 * groups, T - q0);
  const BT* bias_bh = bias + b * sb + h * sh;
  // The blocks of one (b, h) walk the tiles from different starts, so that
  // they do not all ask L2 for the same lines at once: entry e of K's
  // sequence (pass 1's tiles, then, streamed, pass 2's) and of V's (pass
  // 2's) is tile (e + rot) % tiles.
  const int rot = qt % tiles;
  const int G = 2 * tiles;  // copy groups: K's entries, then V's (resident) or K's with V's

  // The producer warps (the last PRODUCERS): copy group g (q with K's
  // entry 0; K's entry g; then V's entry g - tiles, streamed with K's entry
  // g), one cp.async group each; before group g goes out, group g - lag has
  // landed and its barrier takes the producers' arrivals. Streamed, a group
  // waits until the consumers are done with the group a lap before it in
  // the same slots. The first PRE groups go out before the block's set-up
  // barrier, so that their trip to memory overlaps the set-up. A bias that
  // is not staged goes with K's tiles (copy_bias): in pass 1's groups when
  // it is kept whole, in every group when it is ringed; except a bias kept
  // whole as one span (span_of), which goes in the set-up: its middle
  // issued first, by one bulk copy.
  const bool producer = tid >= consumers;
  const int plane = tid - consumers;  // a producer's lane among the producer warps
  const bool by_span = !kStaged && resident && ss == 1 && st >= S && st <= tiles * BK;
  const int pitch = by_span ? (int)st : resident ? whole_pitch(tiles) : BP;
  const BT* span = bias_bh + q0 * st;                      // its first key
  const int span_len = by_span ? (qrows - 1) * (int)st + S : 0;  // keys, gaps included
  const Span sp = span_of(span, span_len * (int)sizeof(BT));
  const int shift = by_span ? (int)((sp.a & 15) / sizeof(BT)) : 0;  // its place's offset
  const int chunk = kStaged ? 0 : copy_chunk(bias, sb, sh, st, ss);
  auto issue = [&](int gi) {
    const __nv_bfloat16* kb = k + (size_t)bh * S * D;
    const __nv_bfloat16* vb = v + (size_t)bh * S * D;
    if (gi == 0) copy_rows<D>(q_s, q + ((size_t)bh * T + q0) * D, qrows, plane);
    if (gi < tiles || !resident) {
      const int tile = (gi + rot) % tiles;
      copy_rows<D>(k_s + (resident ? tile : gi % RING) * BK * P, kb + (size_t)tile * BK * D,
                   min(BK, S - tile * BK), plane);
      if (!kStaged && !by_span)
        copy_bias(bias_t + (resident ? tile * BK : gi % RING * slot_elems), pitch,
                  bias_bh + q0 * st + tile * BK * ss, st, (int)ss, qrows,
                  min(BK, S - tile * BK), chunk, plane);
    }
    if (gi >= tiles) {
      const int e = gi - tiles, tile = (e + rot) % tiles;
      copy_rows<D>(v_s + (resident ? tile : e % RING) * BK * P, vb + (size_t)tile * BK * D,
                   min(BK, S - tile * BK), plane);
    }
    cp_async_commit();
  };
  if (producer)
    for (int gi = 0; gi < PRE; ++gi) issue(gi);  // G >= 2 >= PRE

  if (tid == 0) {
    for (int i = 0; i < (resident ? G : RING); ++i) mbar_init(&full[i], 32 * PRODUCERS);
    if (!resident)
      for (int i = 0; i < RING; ++i) mbar_init(&empty[i], consumers / 32);
    if (by_span && sp.hi > sp.lo) {
      // the barriers, seen by the bulk copy's completion; then the span's
      // middle, counted by full[0]
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_tx(&full[0], (int)(sp.hi - sp.lo));
      bulk_copy(reinterpret_cast<char*>(bias_t) + (sp.lo - (sp.a & ~(uintptr_t)15)),
                reinterpret_cast<const void*>(sp.lo), (int)(sp.hi - sp.lo), &full[0]);
    }
  }
  // Rows no copy fills: q rows past T, the bias's rows past T (in its place,
  // past a span's end, or in every slot), and the rows past S that the
  // last tile's chunks read, in its place (resident) or in its slot when it
  // is the slot's first tile (streamed; else an earlier tile's finite
  // values are there).
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < (16 * groups - qrows) * (D / 8); e += blockDim.x)
    *reinterpret_cast<uint4*>(q_s + (qrows + e / (D / 8)) * P + 8 * (e % (D / 8))) = zero;
  if (!kStaged && qrows < 16 * groups) {
    const int end = 16 * groups * (resident ? whole_pitch(tiles) : BP) * (int)sizeof(BT) / 16;
    const int from = by_span ? ((shift + span_len) * (int)sizeof(BT) + 15) / 16
                             : qrows * pitch * (int)sizeof(BT) / 16;  // uint4 of a slot
    const int n = end - from;
    for (int e = tid; e < (resident ? 1 : RING) * n; e += blockDim.x)
      reinterpret_cast<uint4*>(bias_t + e / n * slot_elems)[from + e % n] = zero;
  }
  const int last = S - (tiles - 1) * BK, pad = (last + 15) / 16 * 16 - last;
  const int first = tiles - 1 - rot;  // the last tile's entry in the sequence
  if (resident || first < RING) {
    const int row0 = (resident ? tiles - 1 : first) * BK + last;
    for (int e = tid; e < pad * (D / 8); e += blockDim.x) {
      const int off = (row0 + e / (D / 8)) * P + 8 * (e % (D / 8));
      *reinterpret_cast<uint4*>(k_s + off) = zero;
      *reinterpret_cast<uint4*>(v_s + off) = zero;
    }
  }
  if constexpr (kStaged)  // the bias in fp32, -inf past S
    for (int j = tid; j < S + pad; j += blockDim.x)
      bias_s[j] = j < S ? bias_f32(bias_bh + j * ss) : -INFINITY;
  if (by_span) {
    // the span's ends, by plain loads; past its end, zeros up to the next
    // 16-byte boundary, where the rows past T start
    constexpr int E = 16 / sizeof(BT);  // more keys than an end holds
    for (int e = tid; e < 2 * E; e += blockDim.x) {
      const int i = e < E ? e : (int)((sp.hi - sp.a) / sizeof(BT)) + e - E;
      if (e >= E)
        bias_t[shift + i] = i < span_len ? span[i] : BT(0.f);
      else if (sp.a + i * sizeof(BT) < sp.lo)
        bias_t[shift + i] = span[i];
    }
  }
  __syncthreads();

  if (producer) {
    // Streamed, at most RING - 1 groups run ahead of the one released, or
    // the producer would wait for a slot that the consumers free only after
    // that release.
    const int lag = resident ? LAG : RING - 1;
    for (int gi = PRE; gi < G + lag; ++gi) {
      const int done = gi - lag;  // released before group gi goes out
      if (done >= 0) {
        cp_async_wait(min(gi, G) - 1 - done);
        mbar_arrive(&full[resident ? done : done % RING]);
      }
      if (gi < G) {
        if (!resident && gi >= RING) mbar_wait(&empty[gi % RING], (gi / RING - 1) & 1);
        issue(gi);
      }
    }
    return;
  }

  const int group = warp / SHARES, share = warp % SHARES;
  const int g = lane / 4, t = lane % 4;
  // this thread's rows g and g + 8 of the group (their output is written
  // where they are below T)
  const int ra = q0 + 16 * group + g, rb = ra + 8;
  // Unless staged: the bias of the thread's row g at the chunk's key 2t in
  // the place of entry gi of tile `tile`, and row g + 8's off8 further.
  const BT* bt0 = bias_t + shift + (16 * group + g) * pitch + 16 * share + 2 * t;
  const int off8 = 8 * pitch;
  auto bias_of = [&](int tile, int gi) {
    return bt0 + (resident ? tile * BK : gi % RING * slot_elems);
  };
  auto wait_group_of = [&](int gi) {
    mbar_wait(&full[resident ? gi : gi % RING], resident ? 0 : (gi / RING) & 1);
  };
  auto release = [&](int gi) {  // streamed: this warp is done with group gi's slots
    if (!resident) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[gi % RING]);
    }
  };

  // The warp's q fragments (A of m16n8k16), by ldmatrix x4: rows 0-7 / 8-15
  // of the group's 16, columns 0-7 / 8-15 of each 16-column step.
  wait_group_of(0);
  uint32_t qf[D / 16][4];
  const __nv_bfloat16* qaddr = q_s + (16 * group + (lane & 15)) * P + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], qaddr + 16 * kk);

  // Pass 1: the max m and the sum l of exp(s - m) over the warp's keys, per
  // row (g for r = 0, g + 8 for r = 1). A thread keeps the sum of its own
  // keys; the quad's four are added at the end.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0, tile = rot; i < tiles; ++i, tile = tile + 1 == tiles ? 0 : tile + 1) {
    wait_group_of(i);
    const int key0 = tile * BK + 16 * share;
    if (key0 < S) {
      const int slot = resident ? tile : i % RING;
      float s[2][4];
      scores<D, kStaged>(s, qf, k_s + (slot * BK + 16 * share) * P, bias_s, bias_of(tile, i),
                         off8, key0, S, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float n = fmaxf(m[r], quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                                   fmaxf(s[1][2 * r], s[1][2 * r + 1]))));
        // n is -inf while every key the warp has seen of this row has bias
        // -inf: shift by 0 then, so that no exp(-inf - -inf) arises
        const float z = n == -INFINITY ? 0.f : n;
        l[r] = l[r] * exp_from(m[r], z) + exp_from(s[0][2 * r], z) +
               exp_from(s[0][2 * r + 1], z) + exp_from(s[1][2 * r], z) +
               exp_from(s[1][2 * r + 1], z);
        m[r] = n;
      }
    }
    release(i);
  }

  // The row group's M and L over its four warps, in warp order. A warp that
  // saw no key has m = -inf and l = 0, and adds 0.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    if (t == 0) stats[(group * SHARES + share) * 16 + g + 8 * r] = make_float2(m[r], sum);
  }
  consumers_sync(consumers);
  float M[2], R[2];  // the row's max and the reciprocal of its sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float top = -INFINITY, sum = 0.f;
#pragma unroll
    for (int w = 0; w < SHARES; ++w)
      top = fmaxf(top, stats[(group * SHARES + w) * 16 + g + 8 * r].x);
#pragma unroll
    for (int w = 0; w < SHARES; ++w) {
      const float2 a = stats[(group * SHARES + w) * 16 + g + 8 * r];
      sum += a.y * exp_from(a.x, top);
    }
    M[r] = top;
    R[r] = 1.f / sum;
  }

  // Pass 2: P = bf16(exp(s - M) * (1 / L)), acc += P . V over the warp's keys.
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int i = 0, tile = rot; i < tiles; ++i, tile = tile + 1 == tiles ? 0 : tile + 1) {
    wait_group_of(tiles + i);  // resident: V's entry i (K is still in place); streamed: both
    const int key0 = tile * BK + 16 * share;
    if (key0 < S) {
      const int kslot = resident ? tile : (tiles + i) % RING, vslot = resident ? tile : i % RING;
      float s[2][4];
      scores<D, kStaged>(s, qf, k_s + (kslot * BK + 16 * share) * P, bias_s,
                         bias_of(tile, tiles + i), off8, key0, S, lane);
      const uint32_t p[4] = {
          pack_bf16(exp_from(s[0][0], M[0]) * R[0], exp_from(s[0][1], M[0]) * R[0]),
          pack_bf16(exp_from(s[0][2], M[1]) * R[1], exp_from(s[0][3], M[1]) * R[1]),
          pack_bf16(exp_from(s[1][0], M[0]) * R[0], exp_from(s[1][1], M[0]) * R[0]),
          pack_bf16(exp_from(s[1][2], M[1]) * R[1], exp_from(s[1][3], M[1]) * R[1])};
      // ldmatrix x4.trans: keys 0-7 / 8-15 of the chunk, columns 8n.. / 8(n+1)..
      const __nv_bfloat16* vaddr =
          v_s + (vslot * BK + 16 * share + (lane & 15)) * P + 8 * (lane >> 4);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vaddr + 8 * n);
        mma_bf16(acc[n], p, bv[0], bv[1]);
        mma_bf16(acc[n + 1], p, bv[2], bv[3]);
      }
    }
    release(tiles + i);
  }

  // The four warps' partial sums, added in fp32 in warp order through the
  // space K and V held; warp `share` of the group writes output tiles
  // share, share + 4, ...
  consumers_sync(consumers);
  float4* part = reinterpret_cast<float4*>(k_s);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    part[((group * SHARES + share) * NT + n) * 32 + lane] =
        make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  consumers_sync(consumers);
  __nv_bfloat16* ob = out + (size_t)bh * T * D;
  for (int n = share; n < NT; n += SHARES) {
    float4 a = part[(group * SHARES * NT + n) * 32 + lane];
#pragma unroll
    for (int w = 1; w < SHARES; ++w) {
      const float4 c = part[((group * SHARES + w) * NT + n) * 32 + lane];
      a.x += c.x;
      a.y += c.y;
      a.z += c.z;
      a.w += c.w;
    }
    const int col = 8 * n + 2 * t;
    if (ra < T) *reinterpret_cast<uint32_t*>(ob + (size_t)ra * D + col) = pack_bf16(a.x, a.y);
    if (rb < T) *reinterpret_cast<uint32_t*>(ob + (size_t)rb * D + col) = pack_bf16(a.z, a.w);
  }
}

// Read once per device: 0 until set, then 1 + the setter's cudaError_t.
// Two threads racing to set it both store the same value, which is harmless.
template <int D, typename BT, bool kStaged>
cudaError_t raise_smem_limit(int dev) {
  static std::atomic<int> state[MAX_DEVICES];
  int val = state[dev].load(std::memory_order_acquire);
  if (val == 0) {
    val = 1 + (int)cudaFuncSetAttribute(keybias_attention_bf16_kernel<D, BT, kStaged>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    state[dev].store(val, std::memory_order_release);
  }
  return (cudaError_t)(val - 1);
}

// Where a launch's K, V and bias lie, and the shared memory that takes: K
// and V resident, else streamed, with the bias staged (one row per (b, h))
// or else kept whole (resident) or ringed (streamed); where neither fits
// (a staged row of a long S), all three streamed, which always fits.
struct Layout {
  bool resident, staged;
  size_t bytes;
};

template <int D>
Layout layout(int S, int groups, bool staged, int esize) {
  for (int i = 0; i < 2; ++i) {
    const bool resident = i == 0;
    const size_t bytes = plan<D>(S, groups, resident, staged, esize).bytes;
    if (bytes <= (size_t)SMEM_MAX) return {resident, staged, bytes};
  }
  return {false, false, plan<D>(S, groups, false, false, esize).bytes};
}

// The block's row groups (1 to 4: 16 to 64 query rows) that take the least
// waves * (rows + 8192 / S): a block's set-up and first trip to memory cost
// about as much as 8192 / S rows of work, and fewer rows a block make more
// blocks, maybe another wave. A wave is as many blocks as fit on the SMs by
// shared memory (the bias's included) and threads.
template <int D>
int pick_groups(int B, int H, int T, int S, bool staged, int esize, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int groups = 1; groups <= max_groups<D>(); ++groups) {
    const long long bytes = (long long)layout<D>(S, groups, staged, esize).bytes;
    const int threads = 32 * (SHARES * groups + PRODUCERS);
    const long long fit = std::max(1LL, std::min(233472 / (bytes + 1024), 2048LL / threads));
    const long long blocks = (long long)((T + 16 * groups - 1) / (16 * groups)) * B * H;
    const long long cost = (blocks + sms * fit - 1) / (sms * fit) * (16 * groups + 8192 / S);
    if (best_cost < 0 || cost < best_cost) best = groups, best_cost = cost;
  }
  return best;
}

// The bias's element strides and stored type beside the launch.
template <typename BT>
struct Bias {
  const BT* p;
  long long sb, sh, st, ss;
};

template <int D, typename BT>
cudaError_t launch_d(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const Bias<BT>& bias, __nv_bfloat16* out, int B, int H, int T, int S,
                     cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool staged = bias.st == 0;
  const int groups = pick_groups<D>(B, H, T, S, staged, sizeof(BT), sms);
  const Layout lay = layout<D>(S, groups, staged, sizeof(BT));
  err = lay.staged ? raise_smem_limit<D, BT, true>(dev) : raise_smem_limit<D, BT, false>(dev);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((T + 16 * groups - 1) / (16 * groups)) * B * H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks, threads = 32 * (SHARES * groups + PRODUCERS);
  if (lay.staged)
    keybias_attention_bf16_kernel<D, BT, true><<<grid, threads, lay.bytes, stream>>>(
        q, k, v, bias.p, bias.sb, bias.sh, bias.st, bias.ss, out, H, T, S, lay.resident);
  else
    keybias_attention_bf16_kernel<D, BT, false><<<grid, threads, lay.bytes, stream>>>(
        q, k, v, bias.p, bias.sb, bias.sh, bias.st, bias.ss, out, H, T, S, lay.resident);
  return cudaGetLastError();
}

template <typename BT>
int launch(const void* q, const void* k, const void* v, const Bias<BT>& bias, void* out, int B,
           int H, int T, int S, int d, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || S <= 0 || d <= 0 || d > DMAX || d % 16 || bias.sb < 0 ||
      bias.sh < 0 || bias.st < 0 || bias.ss < 0 || (long long)(S - 1) * bias.ss > INT_MAX ||
      (uintptr_t)q % 16 || (uintptr_t)out % 4 ||
      (uintptr_t)k % 16 || (uintptr_t)v % 16)
    return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (d) {
    case 16: err = launch_d<16>(qq, kk, vv, bias, oo, B, H, T, S, s); break;
    case 32: err = launch_d<32>(qq, kk, vv, bias, oo, B, H, T, S, s); break;
    case 48: err = launch_d<48>(qq, kk, vv, bias, oo, B, H, T, S, s); break;
    case 64: err = launch_d<64>(qq, kk, vv, bias, oo, B, H, T, S, s); break;
    case 80: err = launch_d<80>(qq, kk, vv, bias, oo, B, H, T, S, s); break;
    case 96: err = launch_d<96>(qq, kk, vv, bias, oo, B, H, T, S, s); break;
    case 112: err = launch_d<112>(qq, kk, vv, bias, oo, B, H, T, S, s); break;
    default: err = launch_d<128>(qq, kk, vv, bias, oo, B, H, T, S, s); break;
  }
  return (int)err;
}

}  // namespace

// q, out: (B, H, T, d); k, v: (B, H, S, d). All bfloat16, contiguous, on
// the current device; q, k and v 16-byte aligned, out 4-byte aligned; d a
// multiple of 16 up to 128. Each entry launches on `stream` and returns the
// launch's cudaError_t (0 on success), or the error of raising the kernel's
// shared-memory limit, which is done once per instantiation and device;
// none synchronises.

// bias: fp32, read at bias[b*sb + h*sh + t*st + s*ss] (element strides, 0
// on a broadcast dimension): K3, and K1 with strides (S, 0, 0, 1).
extern "C" int avi_bias_attention_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, int B, int H, int T, int S,
                                       int d, long long sb, long long sh, long long st,
                                       long long ss, void* stream) {
  return launch(q, k, v, Bias<float>{static_cast<const float*>(bias), sb, sh, st, ss}, out, B,
                H, T, S, d, stream);
}

// The same with a bfloat16 bias.
extern "C" int avi_bias_attention_bf16_bias_bf16(const void* q, const void* k, const void* v,
                                                 const void* bias, void* out, int B, int H,
                                                 int T, int S, int d, long long sb,
                                                 long long sh, long long st, long long ss,
                                                 void* stream) {
  return launch(q, k, v,
                Bias<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(bias), sb, sh, st, ss},
                out, B, H, T, S, d, stream);
}

// key_bias: (B, S) bfloat16, broadcast over heads and query rows (the
// measurement scripts under scripts/ bind this entry).
extern "C" int avi_keybias_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* key_bias, void* out, int B, int H, int T,
                                          int S, int d, void* stream) {
  return launch(q, k, v,
                Bias<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(key_bias), S, 0, 0, 1},
                out, B, H, T, S, d, stream);
}
