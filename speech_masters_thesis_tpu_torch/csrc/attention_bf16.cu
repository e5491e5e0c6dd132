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
// What bounds it on an H100: at the LM's shapes ((8 and 64, 258), H 16, D
// 32) a valid (query, key) pair costs 64 FLOP of products in the forward
// (two passes of S: 96) and 160 in the backward (with the recomputes: 256),
// about 0.003 ms and 0.01 ms at 989 TFLOP/s of bf16 for batch 8; the exp,
// the hash and the latency of each block's walk over its key tiles bound it.
//
// Design. The fp32 forward's online softmax rescales O as it goes, so it
// never holds the normalised P that the TPU kernel rounds before P V. Here
// the forward takes two passes over the block's key tiles: the first the
// row max and sum (the online update of attention_fwd.cu), the second
// recomputes S and forms P = exp(s - m) / l, drops it, rounds it to bf16 as
// the A operand of P V (bf16_mma.cuh's accumulator -> A reuse). The
// backward's dq kernel likewise takes a first pass for delta_r = sum_c dp p
// (the TPU kernel's form, fp32, from the recomputed P; o is bf16 here, so
// g . o would not give it) and writes delta for the dk/dv kernel; its second
// pass forms dS and dQ += dS K. The dk/dv kernel walks the query tiles at or
// after its keys' diagonal as attention_bwd.cu's does. Every kernel is one
// block of 4 warps on a 64-row tile (a warp 16 rows), 128 threads; tiles are
// staged synchronously through shared memory in bf16, once as rows ([row][d],
// the B operand of a product over d) and once transposed ([d][row], the B
// operand of a product over the rows) where a product needs it. Each
// k-step's MMA goes into its own registers and is added to the accumulators
// in fp32 (bf16 mma.sync's accumulation truncates, PERF.md). A first form:
// correct, not tuned (no cp.async pipeline, S recomputed instead of kept).

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

constexpr int LDR = D + 8;     // row stride of a [ROWS][D] tile: 80 bytes, conflict-free fragment reads
constexpr int LDT = ROWS + 8;  // row stride of a [D][ROWS] (transposed) tile
constexpr int KSTEPS = D / 16;

__device__ __forceinline__ uint32_t pair(const bf* p) { return *reinterpret_cast<const uint32_t*>(p); }

// rows [r0, r0 + ROWS) of one head (rows ld elements apart) into `rows`
// ([ROWS][LDR]) and/or transposed into `cols` ([D][LDT]); zeros past `end`
__device__ __forceinline__ void load_tile(bf* rows, bf* cols, const bf* src, size_t ld, int r0, int end) {
  for (int f = threadIdx.x; f < ROWS * (D / 8); f += NT) {
    const int r = f / (D / 8), c8 = 8 * (f % (D / 8));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < end) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c8);
    if (rows) *reinterpret_cast<uint4*>(rows + r * LDR + c8) = v;
    if (cols) {
      const bf* e = reinterpret_cast<const bf*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) cols[(c8 + i) * LDT + r] = e[i];
    }
  }
}

// a warp's A fragments of rows r and r + 8 (rows ld elements apart, zero at
// or past T) for the KSTEPS k-steps over D
__device__ __forceinline__ void load_frags(uint32_t (&a)[KSTEPS][4], const bf* src, size_t ld, int r, int T,
                                           int qd) {
  const bf* ra = src + (size_t)r * ld;
  const bf* rb = src + (size_t)(r + 8) * ld;
  const bool ia = r < T, ib = r + 8 < T;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = 16 * kk + 2 * qd;
    a[kk][0] = ia ? pair(ra + c) : 0u;
    a[kk][1] = ib ? pair(rb + c) : 0u;
    a[kk][2] = ia ? pair(ra + c + 8) : 0u;
    a[kk][3] = ib ? pair(rb + c + 8) : 0u;
  }
}

// acc[j] = A B^T over D for the n-tiles j < j_end of a [ROWS][LDR] tile
// (zero for the others), each k-step added in fp32
__device__ __forceinline__ void products_t(float (&acc)[8][4], const uint32_t (&a)[KSTEPS][4], const bf* tile,
                                           int j_end, int g, int qd) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (j >= j_end) continue;
    const bf* row = tile + (8 * j + g) * LDR + 2 * qd;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t b[2] = {pair(row + 16 * kk), pair(row + 16 * kk + 8)};
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      bf16::mma(part, a[kk], b);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
    }
  }
}

// out[dn] += bf16(X) B over the tile's 64 columns (k-steps of 16 up to
// j_end's n-tile; X the accumulators of products_t, zero past j_end) with B =
// cols[d][column], each k-step added in fp32
__device__ __forceinline__ void products_acc(float (&out)[D / 8][4], const float (&x)[8][4], const bf* cols,
                                             int j_end, int g, int qd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (2 * kk >= j_end) break;
    const uint32_t a[4] = {bf16::pack(x[2 * kk][0], x[2 * kk][1]), bf16::pack(x[2 * kk][2], x[2 * kk][3]),
                           bf16::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           bf16::pack(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    float part[D / 8][4] = {};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const bf* c = cols + (8 * dn + g) * LDT + 16 * kk + 2 * qd;
      const uint32_t b[2] = {pair(c), pair(c + 8)};
      bf16::mma(part[dn], a, b);
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[dn][e] += part[dn][e];
  }
}

// rows r and r + 8 of a warp's [16][D] accumulators, in bf16, to dst (rows HD apart), rows below T
__device__ __forceinline__ void store_rows(bf* dst, const float (&acc)[D / 8][4], int HD, int r, int T, int qd) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= T) continue;
    bf* row = dst + (size_t)(r + 8 * h) * HD + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(row + 8 * dn) = bf16::pack(acc[dn][2 * h], acc[dn][2 * h + 1]);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_bf16_fwd_kernel(
    const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v, int ld,
    const int* __restrict__ lens, const long long* __restrict__ seed, bf* __restrict__ o,
    float2* __restrict__ stats, int T, int H, float scale, Dropout drop) {
  __shared__ __align__(16) bf ks[ROWS * LDR];
  __shared__ __align__(16) bf vt[D * LDT];
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t out_head = (size_t)b * T * HD + (size_t)h * D;
  const int block_end = min(min(q0 + ROWS, T), len);  // the block's keys [0, block_end)
  const int n_tiles = (block_end + ROWS - 1) / ROWS;
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  const int w0 = q0 + 16 * warp;  // this warp's rows w0 + gr and w0 + gr + 8
  uint32_t qa[KSTEPS][4];
  load_frags(qa, q + head, ld, w0 + gr, T, qd);
  int kend[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = w0 + gr + 8 * e;
    kend[e] = row < T ? min(row + 1, len) : 0;  // this row's keys [0, kend)
  }
  const int warp_end = w0 < T ? min(min(w0 + 16, T), len) : 0;

  // pass 1: each row's max and sum, the online update of attention_fwd.cu
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * ROWS;
    __syncthreads();
    load_tile(ks, nullptr, k + head, ld, k0, block_end);
    __syncthreads();
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));
    if (j_end == 0) continue;
    float s[8][4];
    products_t(s, qa, ks, j_end, gr, qd);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 8 * j + 2 * qd + (e & 1);
        s[j][e] = col < kend[r] ? s[j][e] * scale : -INFINITY;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s[j][e] != -INFINITY) sum[e >> 1] += expf(s[j][e] - m_new[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      // a row with no valid key yet keeps m = -inf and l = 0
      l[r] = (m_new[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - m_new[r])) + sum[r];
      m[r] = m_new[r];
    }
  }

  // pass 2: O = bf16(P keep) V with P normalised
  float acc[D / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * ROWS;
    __syncthreads();
    load_tile(ks, nullptr, k + head, ld, k0, block_end);
    load_tile(nullptr, vt, v + head, ld, k0, block_end);
    __syncthreads();
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));
    if (j_end == 0) continue;
    float s[8][4];
    products_t(s, qa, ks, j_end, gr, qd);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 8 * j + 2 * qd + (e & 1);
        float p = 0.f;
        if (col < kend[r]) {
          p = expf(s[j][e] * scale - m[r]) / l[r];
          if (DROP) p *= keep_factor(key, w0 + gr + 8 * r, col, T, drop);
        }
        s[j][e] = p;
      }
    products_acc(acc, s, vt, j_end, gr, qd);
  }

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
  __shared__ __align__(16) bf ks[ROWS * LDR];
  __shared__ __align__(16) bf vs[ROWS * LDR];
  __shared__ __align__(16) bf kt[D * LDT];
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t out_head = (size_t)b * T * HD + (size_t)h * D;  // in g, dq
  const size_t stat0 = ((size_t)b * H + h) * T;
  const int block_end = min(min(q0 + ROWS, T), len);
  const int n_tiles = (block_end + ROWS - 1) / ROWS;
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  const int w0 = q0 + 16 * warp;
  uint32_t qa[KSTEPS][4], ga[KSTEPS][4];
  load_frags(qa, q + head, ld, w0 + gr, T, qd);
  load_frags(ga, g + out_head, HD, w0 + gr, T, qd);
  float m[2], l[2];
  int kend[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = w0 + gr + 8 * e;
    const float2 st = row < T ? stats[stat0 + row] : make_float2(0.f, 1.f);
    m[e] = st.x;
    l[e] = st.y;
    kend[e] = row < T ? min(row + 1, len) : 0;
  }
  const int warp_end = w0 < T ? min(min(w0 + 16, T), len) : 0;

  // the element (j, e)'s p and dp * keep at the tile from k0; p = 0 at an invalid pair
  auto probs = [&](float (&s)[8][4], float (&dp)[8][4], int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 8 * j + 2 * qd + (e & 1);
        const bool valid = col < kend[r];
        s[j][e] = valid ? expf(s[j][e] * scale - m[r]) / l[r] : 0.f;
        if (DROP) dp[j][e] *= valid ? keep_factor(key, w0 + gr + 8 * r, col, T, drop) : 0.f;
      }
  };

  // pass 1: delta_r = sum_c dp p
  float dl[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * ROWS;
    __syncthreads();
    load_tile(ks, nullptr, k + head, ld, k0, block_end);
    load_tile(vs, nullptr, v + head, ld, k0, block_end);
    __syncthreads();
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));
    if (j_end == 0) continue;
    float s[8][4], dp[8][4];
    products_t(s, qa, ks, j_end, gr, qd);
    products_t(dp, ga, vs, j_end, gr, qd);
    probs(s, dp, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dl[e >> 1] += dp[j][e] * s[j][e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
    const int row = w0 + gr + 8 * r;
    if (row < T && qd == 0) delta[stat0 + row] = dl[r];
  }

  // pass 2: dQ = bf16(p (dp - delta) scale) K
  float acc[D / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * ROWS;
    __syncthreads();
    load_tile(ks, kt, k + head, ld, k0, block_end);
    load_tile(vs, nullptr, v + head, ld, k0, block_end);
    __syncthreads();
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));
    if (j_end == 0) continue;
    float s[8][4], dp[8][4];
    products_t(s, qa, ks, j_end, gr, qd);
    products_t(dp, ga, vs, j_end, gr, qd);
    probs(s, dp, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]) * scale;
    products_acc(acc, s, kt, j_end, gr, qd);
  }
  store_rows(dq + out_head, acc, HD, w0 + gr, T, qd);
}

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_bf16_dkdv_kernel(
    const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ v, int ld,
    const float2* __restrict__ stats, const int* __restrict__ lens, const long long* __restrict__ seed,
    const bf* __restrict__ g, const float* __restrict__ delta, bf* __restrict__ dk, bf* __restrict__ dv, int T,
    int H, float scale, Dropout drop) {
  __shared__ __align__(16) bf qs[ROWS * LDR];
  __shared__ __align__(16) bf gs[ROWS * LDR];
  __shared__ __align__(16) bf qt[D * LDT];
  __shared__ __align__(16) bf gt[D * LDT];
  __shared__ float sm[3][ROWS];  // the query tile's m, l, delta
  const int c0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t head_rows = (size_t)b * T * HD + (size_t)h * D;  // in g, dk, dv
  const size_t stat0 = ((size_t)b * H + h) * T;
  const uint32_t hkey = DROP ? head_key(seed, b, h, H) : 0u;
  // query rows r >= c0 see the tile's keys (causal); none does when c0 >= len_b
  const int n_tiles = c0 < len ? (T - c0 + ROWS - 1) / ROWS : 0;

  const int w0 = c0 + 16 * warp;  // this warp's keys w0 + gr and w0 + gr + 8
  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  load_frags(ka, k + head, ld, w0 + gr, T, qd);
  load_frags(va, v + head, ld, w0 + gr, T, qd);
  const bool warp_active = w0 < len;  // a key at or past len_b is valid for no row

  float dka[D / 8][4] = {}, dva[D / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = c0 + it * ROWS;
    __syncthreads();
    load_tile(qs, qt, q + head, ld, r0, T);
    load_tile(gs, gt, g + head_rows, HD, r0, T);
    if (threadIdx.x < ROWS) {
      const int r = r0 + threadIdx.x;
      const float2 st = r < T ? stats[stat0 + r] : make_float2(0.f, 1.f);
      sm[0][threadIdx.x] = st.x;
      sm[1][threadIdx.x] = st.y;
      sm[2][threadIdx.x] = r < T ? delta[stat0 + r] : 0.f;
    }
    __syncthreads();
    const int j_begin = warp_active ? max(0, (w0 - r0) / 8) : 8;
    const int j_end = min(8, (T - r0 + 7) / 8);
    if (j_begin >= j_end) continue;
    float s[8][4], dp[8][4];
    products_t(s, ka, qs, j_end, gr, qd);   // S^T: keys by queries
    products_t(dp, va, gs, j_end, gr, qd);  // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = w0 + gr + 8 * (e >> 1);  // the key
        const int i = 8 * j + 2 * qd + (e & 1);
        const int row = r0 + i;  // the query
        const bool valid = col <= row && col < len && row < T;
        const float p = valid ? expf(s[j][e] * scale - sm[0][i]) / sm[1][i] : 0.f;
        const float keep = DROP ? (valid ? keep_factor(hkey, row, col, T, drop) : 0.f) : 1.f;
        s[j][e] = p * (dp[j][e] * keep - sm[2][i]) * scale;  // dS^T
        dp[j][e] = p * keep;                                 // (P keep)^T
      }
    products_acc(dva, dp, gt, j_end, gr, qd);
    products_acc(dka, s, qt, j_end, gr, qd);
  }
  store_rows(dk + head_rows, dka, HD, w0 + gr, T, qd);
  store_rows(dv + head_rows, dva, HD, w0 + gr, T, qd);
}

// the bf16 kernels' own checks: 16-byte rows (ld in multiples of 8 elements)
bool valid_call(int B, int T, int H, int head_dim, int ld) {
  return B >= 1 && B <= 65535 && T >= 1 && T <= 65535 && H >= 1 && H <= 65535 && head_dim == D &&
         ld >= H * D && ld % 8 == 0;
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
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  const Dropout drop{threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k), *vb = static_cast<const bf*>(v);
  float2* st = reinterpret_cast<float2*>(stats);
  if (dropout)
    attention_bf16_fwd_kernel<true><<<grid, NT, 0, s>>>(qb, kb, vb, ld, lens, seed, static_cast<bf*>(o), st, T, H,
                                                          scale, drop);
  else
    attention_bf16_fwd_kernel<false><<<grid, NT, 0, s>>>(qb, kb, vb, ld, lens, seed, static_cast<bf*>(o), st, T, H,
                                                           scale, drop);
  return (int)cudaGetLastError();
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
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  const Dropout drop{threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k), *vb = static_cast<const bf*>(v);
  const bf* gb = static_cast<const bf*>(g);
  const float2* st = reinterpret_cast<const float2*>(stats);
  if (dropout)
    attention_bf16_dq_kernel<true><<<grid, NT, 0, s>>>(qb, kb, vb, ld, st, lens, seed, gb, static_cast<bf*>(dq),
                                                         delta, T, H, scale, drop);
  else
    attention_bf16_dq_kernel<false><<<grid, NT, 0, s>>>(qb, kb, vb, ld, st, lens, seed, gb, static_cast<bf*>(dq),
                                                          delta, T, H, scale, drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // same stream: the dk/dv kernel reads the delta the dq kernel wrote
  if (dropout)
    attention_bf16_dkdv_kernel<true><<<grid, NT, 0, s>>>(qb, kb, vb, ld, st, lens, seed, gb, delta,
                                                           static_cast<bf*>(dk), static_cast<bf*>(dv), T, H, scale,
                                                           drop);
  else
    attention_bf16_dkdv_kernel<false><<<grid, NT, 0, s>>>(qb, kb, vb, ld, st, lens, seed, gb, delta,
                                                            static_cast<bf*>(dk), static_cast<bf*>(dv), T, H, scale,
                                                            drop);
  return (int)cudaGetLastError();
}
