// Small-T causal attention in bf16 for Hopper (sm_90a): forward and
// recompute backward on bf16 tensor cores (bf16_mma.cuh, m16n8k16), with
// in-kernel dropout.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/attention.py, function
// fused_attention -> pallas_call(_fwd_kernel) and its custom VJP _vjp_bwd ->
// pallas_call(_bwd_kernel), in their bf16 mode (dot_dtype = q's dtype, the
// JAX package's mixed-precision training). The fp32 mode is
// attention_fwd.cu / attention_bwd.cu. Plain versions:
// ops/attention.py:attention_reference and attention_backward_reference
// on bf16 tensors.
//
// What it computes (masking and dropout as in attention_common.cuh), per
// sequence b, head h, query row r, key c, at the TPU kernel's rounding
// points (attention.py:92-185):
//   s    = (q_r . k_c) * scale                 bf16 operands, fp32 sums
//   p    = exp(s - m_r) / l_r                  fp32 (m, l: the row's max and sum)
//   o_r  = sum_c bf16(p keep) v_c              the normalised, dropped P rounded
//   dv_c = sum_r bf16(p keep) g_r
//   dp   = (g_r . v_c) keep,  delta_r = sum_c dp p      fp32
//   ds   = bf16(p (dp - delta_r) scale)
//   dq_r = sum_c ds k_c,  dk_c = sum_r ds q_r
// q, k, v, g, o, dq, dk, dv bf16; stats (m, l) and delta fp32.
//
// What bounds it on an H100: the bytes. The forward reads q, k and v and
// writes o, the backward reads q, k, v and g and writes dq, dk and dv: at
// the LM's (8, 258), H 16, D 32, 0.0025 ms and 0.0044 ms at 3.35 TB/s. A
// valid (query, key) pair costs 4 D = 128 FLOP of products in the forward
// and 10 D = 320 in the backward, a fifth of that at 989 TFLOP/s. What a
// call takes beyond the bytes is the work of each pair a block visits,
// issued by its warps: the exp, the dropout hash (14 integer operations,
// about a third of the forward at p = 0.1) and the masks, and the latency
// along each block's walk. So the kernels spend few instructions a pair:
// exp as exp2 on the special-function unit, 1 / l once a row, each
// thread's own online softmax in the forward's first pass (its row's four
// threads combined once at the end), and dq's first pass keeps its keep
// decisions for its second.
//
// Design. Every kernel is a block of 4 warps on one 64-row tile (a warp 16
// rows; queries in the forward and dq, keys in dk/dv), 128 threads, that
// walks the 64-row tiles of the other side in its causal range, a tile's 64
// columns in two halves of 32 (fewer registers: 4-5 blocks an SM). Tiles lie
// in shared memory as they lie in device memory, [row][d] bf16, rows 80
// bytes apart (conflict-free ldmatrix). Fragments come from ldmatrix.x4:
// the A operands and the B of a product over d (S = Q K^T, dP = G V^T) as
// they lie, the B of a product over the rows (P V, dS K, P^T G, dS^T Q) by
// ldmatrix.trans. The walked tiles (K and V in the forward and dq; Q, G and
// the rows' m, l and delta in dk/dv) go through min(T's tiles, STAGES)
// stages of dynamic shared memory fed by cp.async: a visit's copies are
// issued one visit ahead (two in a ring of 3), before the products of the
// visits in between. Where a block's whole causal range fits in the stages,
// every tile is copied once, all in flight from the start, and the second
// pass reads them resident; past that the stages are a ring and the second
// pass copies again (from L2). On an H100 a ring of 3 beat the resident
// stages at (64, 258) and rings of 2-16 at (8, 1024) (PERF.md). Blocks are
// dispatched longest walk first (grid z; 5-24% faster than shortest first,
// PERF.md): the last query tiles in the forward and dq, the first key tiles
// in dk/dv.
//
// The forward takes two passes over the block's key tiles: the first the
// row max and sum, the second recomputes S and forms P = exp(s - m) / l,
// drops it and rounds it to bf16 as the A operand of P V (bf16_mma.cuh's
// accumulator -> A reuse): the TPU kernel rounds the normalised P, so no
// online rescale of O. The backward is two launches. The dq kernel's first
// pass forms delta_r = sum_c dp p (the TPU kernel's form, fp32, from the
// recomputed P; o is bf16 here, so g . o would not give it), its second dS
// and dQ += dS K; it writes delta ([B, H, T] fp32) to device memory, and
// the dk/dv kernel, launched after it on the same stream, reads it as it
// walks the query tiles at or after its keys' diagonal. So the backward
// computes each valid pair's S and dP three times (dq's two passes, dk/dv's
// one) and its keep draw twice (dq's first pass, dk/dv; three times for key
// tiles past KEEP_TILES, T > 1024), and delta travels through device memory
// from the first launch to the second. One launch for both would need dq's
// or dk/dv's sums across blocks: atomics, whose order changes the bits from
// call to call, or fp32 partial sums a 64-row tile (T / 64 [B, T, H, D]
// tensors each, 338 MB at (64, 258)). Each k-step's MMA goes into its own
// registers and is added to the accumulators in fp32 (bf16 mma.sync's
// accumulation truncates, PERF.md). exp(x) = exp2(x log2 e) (ex2.approx:
// within 2 ulp) and p = e * (1 / l) round apart from the TPU kernel's exp
// and division by an fp32 ulp or two, far inside the bf16 bounds; s scale
// and dp keep are rounded products (no fused multiply-add), as in the plain
// version, so a row's largest p is exactly 1 / l and dS is 0 where the
// plain version's is.

#include <cuda_bf16.h>

#include "attention_common.cuh"
#include "bf16_mma.cuh"

namespace attention_bf16 {
namespace {

using attention::D;
using attention::Dropout;
using attention::head_key;
using attention::keep_factor;
using attention::NT;
using attention::ROWS;
using bf = __nv_bfloat16;

constexpr int LDR = D + 8;  // row stride of a [ROWS][D] tile: 80 bytes, conflict-free ldmatrix
constexpr int TILE = ROWS * LDR;
constexpr int TILE_BYTES = TILE * 2;
constexpr int KSTEPS = D / 16;
constexpr int DN = D / 8;          // n8 tiles over the head
constexpr int HALF = 4;            // n8 tiles a half: a warp takes a tile's 64 columns in two halves of 32
constexpr int STAGES = 3;          // shared-memory stages of the walked tiles, at most
constexpr int KEEP_TILES = 16;     // key tiles whose keep decisions dq's first pass keeps for its second
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KV_SLOT = 2 * TILE_BYTES;                // forward and dq: a K and a V tile
constexpr int QG_SLOT = 2 * TILE_BYTES + 3 * ROWS * 4;  // dk/dv: a Q and a G tile, the rows' m, l, delta
constexpr int FWD_SMEM = TILE_BYTES;       // + slots KV_SLOT: the Q tile
constexpr int DQ_SMEM = 2 * TILE_BYTES;    // + slots KV_SLOT + keep bits: the Q and G tiles
constexpr int DKDV_SMEM = 2 * TILE_BYTES;  // + slots QG_SLOT: the K and V tiles
// every kernel within the 48 KB of dynamic shared memory a launch may take unasked
static_assert(FWD_SMEM + STAGES * KV_SLOT <= 48 * 1024 && DKDV_SMEM + STAGES * QG_SLOT <= 48 * 1024 &&
                  DQ_SMEM + STAGES * KV_SLOT + KEEP_TILES * NT * 4 <= 48 * 1024,
              "attention_bf16: shared memory");

// the stages (slots) a block walks its tiles through at sequence length T
__host__ __device__ inline int stage_count(int T) {
  const int tiles = (T + ROWS - 1) / ROWS;
  return tiles < STAGES ? tiles : STAGES;
}

// dq's keep bits: a word a thread for each of its first min(tiles, KEEP_TILES) key tiles
inline int keep_bytes(int T) {
  const int tiles = (T + ROWS - 1) / ROWS;
  return (tiles < KEEP_TILES ? tiles : KEEP_TILES) * NT * 4;
}

// rows [r0, r0 + ROWS) of one head (rows ld elements apart, 16-byte
// aligned) into a [ROWS][LDR] tile by cp.async, four 16-byte copies a row
// by neighbouring threads; zeros at or past `end`
__device__ __forceinline__ void stage(bf* tile, const bf* src, size_t ld, int r0, int end) {
  for (int f = threadIdx.x; f < ROWS * (D / 8); f += NT) {
    const int r = f / (D / 8), c8 = 8 * (f % (D / 8));
    const bool in = r0 + r < end;
    tf32::cp_async16(tile + r * LDR + c8, in ? src + (size_t)(r0 + r) * ld + c8 : src, in ? 16 : 0);
  }
}

// a warp's A fragments of the 16 rows at `rows` (a [16][LDR] slice of a
// tile) for the KSTEPS k-steps over D
__device__ __forceinline__ void frags_a(uint32_t (&a)[KSTEPS][4], const bf* rows) {
  const int lane = threadIdx.x & 31;
  const bf* p = rows + (lane & 15) * LDR + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) bf16::ldsm_x4(a[kk], p + 16 * kk);
}

// acc[j] = A B^T over D for the n8 tiles j in [j_lo, j_end) of the HALF
// n-tiles from `tile` (rows LDR apart; zero for the others): one
// ldmatrix.x4 an n-tile gives B for both k-steps; each k-step's MMA added in
// fp32
__device__ __forceinline__ void products_t(float (&acc)[HALF][4], const uint32_t (&a)[KSTEPS][4], const bf* tile,
                                           int j_lo, int j_end) {
  const int lane = threadIdx.x & 31;
  const bf* p = tile + (lane & 7) * LDR + 8 * (lane >> 3);
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (j < j_lo || j >= j_end) continue;
    uint32_t b[4];
    bf16::ldsm_x4(b, p + 8 * j * LDR);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t bk[2] = {b[2 * kk], b[2 * kk + 1]};
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      bf16::mma(part, a[kk], bk);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
    }
  }
}

// out[dn] += bf16(X) B over the half's 32 rows from `tile` (k-steps of 16
// rows holding an n-tile in [j_lo, j_end); X the accumulators of
// products_t, zero outside it), B the [row][d] tile by ldmatrix.trans (two
// n8 tiles over d a load), each k-step added in fp32
__device__ __forceinline__ void products_acc(float (&out)[DN][4], const float (&x)[HALF][4], const bf* tile,
                                             int j_lo, int j_end) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const bf* base = tile + (8 * (mi & 1) + (lane & 7)) * LDR + 8 * (mi >> 1);
#pragma unroll
  for (int kk = 0; kk < HALF / 2; ++kk) {
    if (2 * kk >= j_end) break;
    if (2 * kk + 1 < j_lo) continue;
    const uint32_t a[4] = {bf16::pack(x[2 * kk][0], x[2 * kk][1]), bf16::pack(x[2 * kk][2], x[2 * kk][3]),
                           bf16::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           bf16::pack(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    float part[DN][4] = {};
#pragma unroll
    for (int d2 = 0; d2 < DN / 2; ++d2) {
      uint32_t b[4];
      bf16::ldsm_x4_t(b, base + 16 * kk * LDR + 16 * d2);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      bf16::mma(part[2 * d2], a, b0);
      bf16::mma(part[2 * d2 + 1], a, b1);
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[dn][e] += part[dn][e];
  }
}

// rows r and r + 8 of a warp's [16][D] accumulators, in bf16, to dst (rows HD apart), rows below T
__device__ __forceinline__ void store_rows(bf* dst, const float (&acc)[DN][4], int HD, int r, int T, int qd) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= T) continue;
    bf* row = dst + (size_t)(r + 8 * h) * HD + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<uint32_t*>(row + 8 * dn) = bf16::pack(acc[dn][2 * h], acc[dn][2 * h + 1]);
  }
}

// 2^x on the special-function unit (ex2.approx.ftz: within 2 ulp; a
// result below 2^-126 is 0, as exp(-inf) is)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(s scale - m) as exp2((s scale - m) log2e), s scale rounded (no fused
// multiply-add) as in the row's max, so that the max's is 1 exactly
__device__ __forceinline__ float exp_shifted(float s, float scale, float m) {
  return exp2_sfu((__fmul_rn(s, scale) - m) * LOG2E);
}

// p = exp(s scale - m) / l of a valid pair, times 1 / l: the forward and
// both backward kernels form it alike from the same (m, l), so all three
// recompute one P
__device__ __forceinline__ float prob(float s, float scale, float m, float inv_l) {
  return exp_shifted(s, scale, m) * inv_l;
}

// The walk of a block over n tiles, twice (PASSES 2: the forward, dq) or
// once, through `slots` = stage_count(T) stages of `slot_bytes` from
// `base`. Visit it < PASSES n is tile it % n. Resident (n <= slots): tile t
// lives in slot t, copied at its first visit; else visit it takes slot
// it % slots. A visit's copies are issued `ahead` visits before it (1 or 2),
// one commit group a visit (empty when nothing is copied), so visit it's
// group is complete once at most ahead - 1 are in flight.
template <int PASSES>
struct Walk {
  uint8_t* base;
  int slot_bytes, slots, n, ahead;
  bool resident;

  __device__ Walk(uint8_t* base_, int slot_bytes_, int slots_, int n_)
      : base(base_), slot_bytes(slot_bytes_), slots(slots_), n(n_), ahead(max(slots_ - 1, 1)),
        resident(n_ <= slots_) {}
  __device__ uint8_t* slot(int it) const { return base + (resident ? it % n : it % slots) * slot_bytes; }
  // whether visit it copies its tile
  __device__ bool copies(int it) const { return it < PASSES * n && (it < n || !resident); }
  // waits for visit it's copies, then issues visit it + ahead's through copy(it + ahead, slot, tile)
  template <class Copy>
  __device__ uint8_t* next(int it, Copy copy) const {
    if (ahead > 1)
      tf32::cp_async_wait<1>();
    else
      tf32::cp_async_wait<0>();
    __syncthreads();  // visit it's tiles are in; visit it - 1's slot is free
    const int ahead_it = it + ahead;
    if (copies(ahead_it)) copy(ahead_it, slot(ahead_it), ahead_it % n);
    tf32::cp_async_commit();
    return slot(it);
  }
  template <class Copy>
  __device__ void start(Copy copy) const {  // visits 0 .. ahead - 1; the caller's copies so far ride in visit 0's group
    for (int it = 0; it < ahead; ++it) {
      if (copies(it)) copy(it, slot(it), it % n);
      tf32::cp_async_commit();
    }
  }
};

// 5 blocks an SM give ptxas a register target (102) that it keeps without a spill
template <bool DROP>
__global__ void __launch_bounds__(NT, 5) attention_bf16_fwd_kernel(
    const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v, int ld,
    const int* __restrict__ lens, const long long* __restrict__ seed, bf* __restrict__ o,
    float2* __restrict__ stats, int T, int H, float scale, Dropout drop) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf* const qs = reinterpret_cast<bf*>(smem);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS, h = blockIdx.x, b = blockIdx.y;  // the longest walk first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t out_head = (size_t)b * T * HD + (size_t)h * D;
  const int block_end = min(min(q0 + ROWS, T), len);  // the block's keys [0, block_end)
  const int n = (block_end + ROWS - 1) / ROWS;
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  // pass 1 reads K, pass 2 K and V: a ring copies what the pass reads, resident slots both at once
  const Walk<2> walk(smem + FWD_SMEM, KV_SLOT, stage_count(T), n);
  auto copy = [&](int it, uint8_t* slot, int t) {
    bf* kt = reinterpret_cast<bf*>(slot);
    stage(kt, k + head, ld, t * ROWS, block_end);
    if (walk.resident || it >= n) stage(kt + TILE, v + head, ld, t * ROWS, block_end);
  };
  if (n > 0) stage(qs, q + head, ld, q0, T);
  walk.start(copy);

  const int w0 = q0 + 16 * warp;  // this warp's rows w0 + gr and w0 + gr + 8
  int kend[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = w0 + gr + 8 * e;
    kend[e] = row < T ? min(row + 1, len) : 0;  // this row's keys [0, kend)
  }
  const int warp_end = w0 < T ? min(min(w0 + 16, T), len) : 0;
  uint32_t qa[KSTEPS][4];

  // pass 1: each row's max and sum, as each thread's own online update over
  // its columns (no shuffle on the walk), the row's four threads combined after
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n; ++it) {
    const bf* kt = reinterpret_cast<const bf*>(walk.next(it, copy));
    if (it == 0) frags_a(qa, qs + 16 * warp * LDR);
    const int k0 = it * ROWS;
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int jh = j_end - HALF * hf;
      if (jh <= 0) break;
      float s[HALF][4];
      products_t(s, qa, kt + 32 * hf * LDR, 0, jh);
      const int c0 = k0 + 32 * hf + 2 * qd;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < HALF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + (e & 1) < kend[e >> 1]) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e] * scale);
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < HALF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + (e & 1) < kend[e >> 1]) sum[e >> 1] += exp_shifted(s[j][e], scale, mx[e >> 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // a thread with no valid column yet keeps m = -inf and l = 0
        l[r] = (m[r] == -INFINITY ? 0.f : l[r] * exp2_sfu((m[r] - mx[r]) * LOG2E)) + sum[r];
        m[r] = mx[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    float part = m[r] == -INFINITY ? 0.f : l[r] * exp2_sfu((m[r] - mr) * LOG2E);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    m[r] = mr;  // a row with no valid key: m = -inf, l = 0
    l[r] = part;
  }

  // pass 2: O = bf16(P keep) V with P normalised
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  float acc[DN][4] = {};
  for (int it = n; it < 2 * n; ++it) {
    const bf* kt = reinterpret_cast<const bf*>(walk.next(it, copy));
    const int k0 = (it - n) * ROWS;
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int jh = j_end - HALF * hf;
      if (jh <= 0) break;
      float s[HALF][4];
      products_t(s, qa, kt + 32 * hf * LDR, 0, jh);
#pragma unroll
      for (int j = 0; j < HALF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = k0 + 32 * hf + 8 * j + 2 * qd + (e & 1);
          float p = 0.f;
          if (col < kend[r]) {
            p = prob(s[j][e], scale, m[r], inv_l[r]);
            if (DROP) p *= keep_factor(key, w0 + gr + 8 * r, col, T, drop);
          }
          s[j][e] = p;
        }
      products_acc(acc, s, kt + TILE + 32 * hf * LDR, 0, jh);
    }
  }
  tf32::cp_async_wait<0>();  // no copy outlives the block (the empty groups past the walk)

  store_rows(o + out_head, acc, HD, w0 + gr, T, qd);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gr + 8 * r;
    if (row < T && qd == 0) stats[((size_t)b * H + h) * T + row] = make_float2(m[r], l[r]);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_bf16_dq_kernel(
    const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v, int ld,
    const float2* __restrict__ stats, const int* __restrict__ lens, const long long* __restrict__ seed,
    const bf* __restrict__ g, bf* __restrict__ dq, float* __restrict__ delta, int T, int H, float scale,
    Dropout drop) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf* const qs = reinterpret_cast<bf*>(smem);
  bf* const gs = qs + TILE;
  uint32_t* const kept = reinterpret_cast<uint32_t*>(smem + DQ_SMEM + stage_count(T) * KV_SLOT);  // [KEEP_TILES][NT]
  const int q0 = (gridDim.z - 1 - blockIdx.z) * ROWS, h = blockIdx.x, b = blockIdx.y;  // the longest walk first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t out_head = (size_t)b * T * HD + (size_t)h * D;  // in g, dq
  const size_t stat0 = ((size_t)b * H + h) * T;
  const int block_end = min(min(q0 + ROWS, T), len);
  const int n = (block_end + ROWS - 1) / ROWS;
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  const Walk<2> walk(smem + DQ_SMEM, KV_SLOT, stage_count(T), n);
  auto copy = [&](int, uint8_t* slot, int t) {
    bf* kt = reinterpret_cast<bf*>(slot);
    stage(kt, k + head, ld, t * ROWS, block_end);
    stage(kt + TILE, v + head, ld, t * ROWS, block_end);
  };
  if (n > 0) {
    stage(qs, q + head, ld, q0, T);
    stage(gs, g + out_head, HD, q0, T);
  }
  walk.start(copy);

  const int w0 = q0 + 16 * warp;
  float m[2], inv_l[2];
  int kend[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = w0 + gr + 8 * e;
    const float2 st = row < T ? stats[stat0 + row] : make_float2(0.f, 1.f);
    m[e] = st.x;
    inv_l[e] = 1.f / st.y;
    kend[e] = row < T ? min(row + 1, len) : 0;
  }
  const int warp_end = w0 < T ? min(min(w0 + 16, T), len) : 0;
  uint32_t qa[KSTEPS][4], ga[KSTEPS][4];

  // a visit's half hf: p, and dp * keep into dp, at the tile from k0; p = 0
  // at an invalid pair. The first pass draws the keep decisions and, for the
  // first KEEP_TILES tiles, keeps them as bits (32 a thread a tile) for the
  // second.
  auto probs = [&](float (&s)[HALF][4], float (&dp)[HALF][4], int k0, int hf, uint32_t& bits, bool draw) {
#pragma unroll
    for (int j = 0; j < HALF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 32 * hf + 8 * j + 2 * qd + (e & 1), bit = 16 * hf + 4 * j + e;
        const bool valid = col < kend[r];
        s[j][e] = valid ? prob(s[j][e], scale, m[r], inv_l[r]) : 0.f;
        if (DROP) {
          float kf;
          if (draw) {
            kf = valid ? keep_factor(key, w0 + gr + 8 * r, col, T, drop) : 0.f;
            bits |= (uint32_t)(kf != 0.f) << bit;
          } else {
            kf = (bits >> bit) & 1u ? drop.scale : 0.f;
          }
          dp[j][e] = __fmul_rn(dp[j][e], kf);  // rounded, as delta's and dS's dp in the plain version
        }
      }
  };

  // pass 1: delta_r = sum_c dp p
  float dl[2] = {0.f, 0.f};
  for (int it = 0; it < n; ++it) {
    const bf* kt = reinterpret_cast<const bf*>(walk.next(it, copy));
    if (it == 0) {
      frags_a(qa, qs + 16 * warp * LDR);
      frags_a(ga, gs + 16 * warp * LDR);
    }
    const int k0 = it * ROWS;
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));
    uint32_t bits = 0u;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int jh = j_end - HALF * hf;
      if (jh <= 0) break;
      float s[HALF][4], dp[HALF][4];
      products_t(s, qa, kt + 32 * hf * LDR, 0, jh);
      products_t(dp, ga, kt + TILE + 32 * hf * LDR, 0, jh);
      probs(s, dp, k0, hf, bits, true);
#pragma unroll
      for (int j = 0; j < HALF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dl[e >> 1] += dp[j][e] * s[j][e];
    }
    if (DROP && it < KEEP_TILES) kept[it * NT + threadIdx.x] = bits;  // read back by this thread alone
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
    const int row = w0 + gr + 8 * r;
    if (row < T && qd == 0) delta[stat0 + row] = dl[r];
  }

  // pass 2: dQ = bf16(p (dp - delta) scale) K
  float acc[DN][4] = {};
  for (int it = n; it < 2 * n; ++it) {
    const bf* kt = reinterpret_cast<const bf*>(walk.next(it, copy));
    const int t = it - n, k0 = t * ROWS;
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));
    const bool draw = t >= KEEP_TILES;
    uint32_t bits = DROP && !draw && j_end > 0 ? kept[t * NT + threadIdx.x] : 0u;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int jh = j_end - HALF * hf;
      if (jh <= 0) break;
      float s[HALF][4], dp[HALF][4];
      products_t(s, qa, kt + 32 * hf * LDR, 0, jh);
      products_t(dp, ga, kt + TILE + 32 * hf * LDR, 0, jh);
      probs(s, dp, k0, hf, bits, draw);
#pragma unroll
      for (int j = 0; j < HALF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]) * scale;
      products_acc(acc, s, kt + 32 * hf * LDR, 0, jh);
    }
  }
  tf32::cp_async_wait<0>();
  store_rows(dq + out_head, acc, HD, w0 + gr, T, qd);
}

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_bf16_dkdv_kernel(
    const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v, int ld,
    const float2* __restrict__ stats, const int* __restrict__ lens, const long long* __restrict__ seed,
    const bf* __restrict__ g, const float* __restrict__ delta, bf* __restrict__ dk, bf* __restrict__ dv, int T,
    int H, float scale, Dropout drop) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf* const kts = reinterpret_cast<bf*>(smem);
  bf* const vts = kts + TILE;
  const int t0 = blockIdx.z, c0 = t0 * ROWS, h = blockIdx.x;  // the longest walk first
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t head_rows = (size_t)b * T * HD + (size_t)h * D;  // in g, dk, dv
  const size_t stat0 = ((size_t)b * H + h) * T;
  const uint32_t hkey = DROP ? head_key(seed, b, h, H) : 0u;
  // query rows r >= c0 see the tile's keys (causal): query tiles t0 .. gridDim.z - 1; none when c0 >= len_b
  const int n = c0 < len ? gridDim.z - t0 : 0;

  const Walk<1> walk(smem + DKDV_SMEM, QG_SLOT, stage_count(T), n);
  auto copy = [&](int, uint8_t* slot, int t) {
    const int r0 = c0 + t * ROWS;
    bf* qt = reinterpret_cast<bf*>(slot);
    stage(qt, q + head, ld, r0, T);
    stage(qt + TILE, g + head_rows, HD, r0, T);
    float* st = reinterpret_cast<float*>(slot + 2 * TILE_BYTES);  // m, l, delta of the tile's rows
    for (int f = threadIdx.x; f < 3 * ROWS; f += NT) {
      const int w = f / ROWS, i = f % ROWS, r = r0 + i;
      if (r < T)
        tf32::cp_async4(st + f, w == 2 ? delta + stat0 + r : reinterpret_cast<const float*>(stats + stat0 + r) + w);
      else
        st[f] = 0.f;  // read by no valid pair
    }
  };
  if (n > 0) {
    stage(kts, k + head, ld, c0, T);
    stage(vts, v + head, ld, c0, T);
  }
  walk.start(copy);

  const int w0 = c0 + 16 * warp;  // this warp's keys w0 + gr and w0 + gr + 8
  const bool warp_active = w0 < len;  // a key at or past len_b is valid for no row
  uint32_t ka[KSTEPS][4], va[KSTEPS][4];

  float dka[DN][4] = {}, dva[DN][4] = {};
  for (int it = 0; it < n; ++it) {
    uint8_t* slot = walk.next(it, copy);
    if (it == 0) {
      frags_a(ka, kts + 16 * warp * LDR);
      frags_a(va, vts + 16 * warp * LDR);
    }
    const bf* qt = reinterpret_cast<const bf*>(slot);
    const bf* gt = qt + TILE;
    const float* sm = reinterpret_cast<const float*>(slot + 2 * TILE_BYTES);
    const int r0 = c0 + it * ROWS;
    // the query n-tiles [j_begin, j_end) that hold a row at or after the warp's first key
    const int j_begin = warp_active ? max(0, (w0 - r0) / 8) : 8;
    const int j_end = min(8, (T - r0 + 7) / 8);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int jl = j_begin - HALF * hf, jh = j_end - HALF * hf;
      if (jh <= 0 || jl >= jh) break;
      if (jl >= HALF) continue;
      float s[HALF][4], dp[HALF][4];
      products_t(s, ka, qt + 32 * hf * LDR, jl, jh);   // S^T: keys by queries
      products_t(dp, va, gt + 32 * hf * LDR, jl, jh);  // dP^T
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        if (j < jl || j >= jh) continue;  // their products are zero, and so stay dS^T and (P keep)^T
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 32 * hf + 8 * j + 2 * qd + c, row = r0 + i;  // the query
          const float m = sm[i], inv_l = 1.f / sm[ROWS + i], dl = sm[2 * ROWS + i];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int e = 2 * rr + c, col = w0 + gr + 8 * rr;  // the key
            const bool valid = col <= row && col < len && row < T;
            const float p = valid ? prob(s[j][e], scale, m, inv_l) : 0.f;
            const float keep = DROP ? (valid ? keep_factor(hkey, row, col, T, drop) : 0.f) : 1.f;
            s[j][e] = p * (__fmul_rn(dp[j][e], keep) - dl) * scale;  // dS^T, dp keep rounded as in dq
            dp[j][e] = p * keep;                           // (P keep)^T
          }
        }
      }
      products_acc(dva, dp, gt + 32 * hf * LDR, jl, jh);
      products_acc(dka, s, qt + 32 * hf * LDR, jl, jh);
    }
  }
  tf32::cp_async_wait<0>();
  store_rows(dk + head_rows, dka, HD, w0 + gr, T, qd);
  store_rows(dv + head_rows, dva, HD, w0 + gr, T, qd);
}

// the bf16 kernels' own checks: 16-byte rows (ld in multiples of 8 elements)
bool valid_call(int B, int T, int H, int head_dim, int ld) {
  return B >= 1 && B <= 65535 && T >= 1 && T <= 65535 && H >= 1 && H <= 65535 && head_dim == D &&
         ld >= H * D && ld % 8 == 0;
}

// grid: (H, B, 64-row tiles); the kernels take grid z longest walk first
dim3 grid(int B, int T, int H) { return dim3(H, B, (T + ROWS - 1) / ROWS); }

template <bool DROP>
cudaError_t launch_fwd(const bf* q, const bf* k, const bf* v, int ld, const int* lens, const long long* seed, bf* o,
                       float2* stats, int B, int T, int H, float scale, Dropout drop, cudaStream_t s) {
  attention_bf16_fwd_kernel<DROP><<<grid(B, T, H), NT, FWD_SMEM + stage_count(T) * KV_SLOT, s>>>(
      q, k, v, ld, lens, seed, o, stats, T, H, scale, drop);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t launch_bwd(const bf* q, const bf* k, const bf* v, int ld, const float2* stats, const int* lens,
                       const long long* seed, const bf* g, bf* dq, bf* dk, bf* dv, float* delta, int B, int T, int H,
                       float scale, Dropout drop, cudaStream_t s) {
  attention_bf16_dq_kernel<DROP><<<grid(B, T, H), NT, DQ_SMEM + stage_count(T) * KV_SLOT + keep_bytes(T), s>>>(
      q, k, v, ld, stats, lens, seed, g, dq, delta, T, H, scale, drop);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: the dk/dv kernel reads the delta the dq kernel wrote
  attention_bf16_dkdv_kernel<DROP><<<grid(B, T, H), NT, DKDV_SMEM + stage_count(T) * QG_SLOT, s>>>(
      q, k, v, ld, stats, lens, seed, g, delta, dk, dv, T, H, scale, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace attention_bf16

// Launches the bf16 forward on `stream`; returns a cudaError_t (0 on
// success). q/k/v [B, T, H, head_dim] bf16 with rows `ld` elements apart
// (ld a multiple of 8), 16-byte aligned; lens int32 [B]; seed int64 [1]
// (read only when dropout is on); o [B, T, H, head_dim] bf16 and stats [B,
// H, T, 2] fp32 (each row's max and sum) are written.
extern "C" int attention_fwd_bf16(const void* q, const void* k, const void* v, int ld, const int* lens,
                                  const long long* seed, void* o, float* stats, int B, int T, int H, int head_dim,
                                  float scale, int dropout, unsigned threshold, float keep_scale, void* stream) {
  using namespace attention_bf16;
  if (!valid_call(B, T, H, head_dim, ld)) return (int)cudaErrorInvalidValue;
  const Dropout drop{threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k), *vb = static_cast<const bf*>(v);
  float2* st = reinterpret_cast<float2*>(stats);
  bf* ob = static_cast<bf*>(o);
  return (int)(dropout ? launch_fwd<true>(qb, kb, vb, ld, lens, seed, ob, st, B, T, H, scale, drop, s)
                       : launch_fwd<false>(qb, kb, vb, ld, lens, seed, ob, st, B, T, H, scale, drop, s));
}

// Launches both bf16 backward kernels on `stream`; returns a cudaError_t.
// q/k/v as in attention_fwd_bf16; stats [B, H, T, 2] from it; g, dq, dk, dv
// contiguous [B, T, H, head_dim] bf16; delta [B, H, T] fp32 (scratch, the
// dq kernel writes it for the dk/dv kernel).
extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v, int ld, const float* stats,
                                  const int* lens, const long long* seed, const void* g, void* dq, void* dk, void* dv,
                                  float* delta, int B, int T, int H, int head_dim, float scale, int dropout,
                                  unsigned threshold, float keep_scale, void* stream) {
  using namespace attention_bf16;
  if (!valid_call(B, T, H, head_dim, ld)) return (int)cudaErrorInvalidValue;
  const Dropout drop{threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k), *vb = static_cast<const bf*>(v);
  const bf* gb = static_cast<const bf*>(g);
  const float2* st = reinterpret_cast<const float2*>(stats);
  bf *dqb = static_cast<bf*>(dq), *dkb = static_cast<bf*>(dk), *dvb = static_cast<bf*>(dv);
  return (int)(dropout ? launch_bwd<true>(qb, kb, vb, ld, st, lens, seed, gb, dqb, dkb, dvb, delta, B, T, H, scale,
                                          drop, s)
                       : launch_bwd<false>(qb, kb, vb, ld, st, lens, seed, gb, dqb, dkb, dvb, delta, B, T, H, scale,
                                           drop, s));
}
