// Shared by the small-T attention kernels (attention_fwd.cu, attention_bwd.cu):
// compile-time shapes, the masking and dropout rules and the call checks;
// the tensor-core engine both run on (tf32_mma.cuh): tiles staged by
// cp.async, split TF32 A fragments of a warp's 16 rows, S = A B^T over D and
// the accumulators fed back as the A operand of a second product.
//
// Layout. q, k and v are [B, T, H, D] with D contiguous and rows `ld` floats
// apart (ld = 3*H*D for the views of the LM's packed in-projection, H*D for
// contiguous tensors); o, g, dq, dk and dv are contiguous [B, T, H, D].
//
// Masking (ops/pallas/attention.py:_probs): key c is valid for query row r
// when c <= r and c < len_b. The kernels never visit an invalid pair, which
// is what the -1e9 fill of the plain version gives whenever a row has a
// valid key (exp(-1e9 - max) is 0 in fp32): masked keys never reach O or any
// gradient. Query rows at or past len_b attend over the valid prefix.
//
// Dropout (ops/attention.py:dropout_bits computes the same bits). The
// TPU's hardware PRNG cannot be reproduced, so each element of P draws one
// 32-bit value from hash.cuh: key = stream_key(seed, b*H + h), counter
// r*T + c; the element is kept when the draw is >= threshold =
// int(p * 2^32) and then scaled by 1/(1-p). The backward regenerates the
// same bits from the seed, which the kernels read from device memory (the
// LM draws it on the card, so nothing waits for the host).
//
// Blocks. Every kernel runs 4 warps on one 64-row tile (queries for the
// forward and dq, keys for dk/dv); a warp owns 16 of its rows. Shared-memory
// tiles keep rows 36 floats apart, so both fragment reads (row g, column q
// and row 2q (+1), column g) fall on 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash.cuh"
#include "tf32_mma.cuh"

namespace attention {

constexpr int D = 32;         // head dimension (the LM's 512 / 16)
constexpr int ROWS = 64;      // rows per tile: queries (forward, dq) or keys (dk/dv)
constexpr int D4 = D / 4;
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;  // threads per block of every attention kernel
constexpr int LDS = D + 4;      // shared-memory row stride of a [ROWS][D] tile
constexpr int KSTEPS = D / 8;

struct Dropout {
  uint32_t threshold;  // keep when the draw is >= threshold
  float scale;         // 1 / (1 - p), as float32
};

__device__ __forceinline__ uint32_t head_key(const long long* seed, int b, int h, int H) {
  return stream_key((uint32_t)seed[0], (uint32_t)(b * H + h));
}

// 0 or the keep scale of element (r, c) of head `key`'s P
__device__ __forceinline__ float keep_factor(uint32_t key, int r, int c, int T, const Dropout& drop) {
  return hash_draw(key, (uint32_t)r * (uint32_t)T + (uint32_t)c) >= drop.threshold ? drop.scale : 0.f;
}

// rows [r0, r0 + ROWS) of one head (rows ld floats apart) into a
// [ROWS][LDS] tile by cp.async; zero past `end`
__device__ __forceinline__ void load_tile_async(float* tile, const float* src, int ld, int r0, int end) {
  for (int f = threadIdx.x; f < ROWS * D4; f += NT) {
    const int r = f / D4, c4 = f % D4;
    const bool in = r0 + r < end;
    tf32::cp_async16(tile + r * LDS + 4 * c4, in ? src + (size_t)(r0 + r) * ld + 4 * c4 : src, in ? 16 : 0);
  }
}

// a warp's A fragments of rows r and r + 8 (global, rows ld floats apart,
// zero at or past T), split, for the KSTEPS k-steps over D
__device__ __forceinline__ void load_frags(tf32::FragA (&f)[KSTEPS], const float* src, int ld, int r,
                                           int T, int qd) {
  const float* ra = src + (size_t)r * ld;
  const float* rb = src + (size_t)(r + 8) * ld;
  const bool ia = r < T, ib = r + 8 < T;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = 8 * kk + qd;
    f[kk] = tf32::frag_a(ia ? __ldg(ra + c) : 0.f, ib ? __ldg(rb + c) : 0.f, ia ? __ldg(ra + c + 4) : 0.f,
                         ib ? __ldg(rb + c + 4) : 0.f);
  }
}

// acc[j] = A B^T over D for n-tiles j in [j0, j1) of a tile held [row][d],
// the k-steps in order. STEP_ADD (the forward) runs each k-step's three
// MMAs into their own register and adds it to acc in fp32, as conv_mma.cuh
// does (the tensor cores' accumulation truncates); the backward keeps the
// whole product in one register.
template <int NJ, bool STEP_ADD = false>
__device__ __forceinline__ void products_t(float (&acc)[NJ][4], const tf32::FragA (&a)[KSTEPS],
                                           const float* tile, int j0, int j1, int g, int qd) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (j0 + j >= j1) continue;
    const float* row = tile + (8 * (j0 + j) + g) * LDS + qd;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if constexpr (STEP_ADD) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        tf32::mma3(part, a[kk], tf32::frag_b(row[8 * kk], row[8 * kk + 4]));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
      } else {
        tf32::mma3(acc[j], a[kk], tf32::frag_b(row[8 * kk], row[8 * kk + 4]));
      }
    }
  }
}

// out[dn] += X B over the n-tiles j in [j0, j1) (their 8 columns the k-steps,
// X the accumulators in C layout) with B = tile[column][d]; STEP_ADD as in
// products_t, one k-step an n-tile of X
template <int NJ, bool STEP_ADD = false>
__device__ __forceinline__ void products_acc(float (&out)[KSTEPS][4], const float (&x)[NJ][4],
                                             const float* tile, int j0, int j1, int g, int qd) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j0 + j >= j1) continue;
    const tf32::FragA fa = tf32::frag_a(x[j][0], x[j][2], x[j][1], x[j][3]);
    const float* r0 = tile + (8 * (j0 + j) + 2 * qd) * LDS + g;
    if constexpr (STEP_ADD) {
      float part[KSTEPS][4] = {};
#pragma unroll
      for (int dn = 0; dn < KSTEPS; ++dn) tf32::mma3(part[dn], fa, tf32::frag_b(r0[8 * dn], r0[LDS + 8 * dn]));
#pragma unroll
      for (int dn = 0; dn < KSTEPS; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[dn][e] += part[dn][e];
    } else {
#pragma unroll
      for (int dn = 0; dn < KSTEPS; ++dn) tf32::mma3(out[dn], fa, tf32::frag_b(r0[8 * dn], r0[LDS + 8 * dn]));
    }
  }
}

// checks shared by the C entry points
inline bool valid_call(int B, int T, int H, int head_dim, int ld) {
  return B >= 1 && B <= 65535 && T >= 1 && T <= 65535 && H >= 1 && H <= 65535 && head_dim == D &&
         ld >= H * D && ld % 4 == 0;
}

}  // namespace attention
