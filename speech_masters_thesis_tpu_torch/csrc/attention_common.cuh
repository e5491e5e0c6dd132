// Shared by the small-T attention kernels (attention_fwd.cu, attention_bwd.cu):
// compile-time shapes, the masking and dropout rules and the call checks;
// the forward's one-row-a-thread tile loads and row products.
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
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash.cuh"

namespace attention {

constexpr int D = 32;         // head dimension (the LM's 512 / 16)
constexpr int ROWS = 64;      // rows per tile: queries (forward, dq) or keys (dk/dv)
constexpr int NT = ROWS;      // the forward's threads per block: one per row of the tile
constexpr int CHUNK = 16;     // keys per online-softmax update in the forward
constexpr int D4 = D / 4;

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

// rows [r0, r0 + ROWS) of one head of a [.., T, ld] tensor (head offset
// applied by the caller) into a [ROWS][D] tile; zero past `end`
__device__ __forceinline__ void load_tile(float* tile, const float* src, int ld, int r0, int end) {
  for (int f = threadIdx.x; f < ROWS * D4; f += NT) {
    const int r = f / D4, c4 = f % D4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < end) val = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * ld) + c4);
    reinterpret_cast<float4*>(tile)[f] = val;
  }
}

// one row of D floats (global, 16-byte aligned) into registers
__device__ __forceinline__ void load_row(float (&dst)[D], const float* src) {
#pragma unroll
  for (int c = 0; c < D4; ++c) {
    const float4 val = __ldg(reinterpret_cast<const float4*>(src) + c);
    dst[4 * c] = val.x;
    dst[4 * c + 1] = val.y;
    dst[4 * c + 2] = val.z;
    dst[4 * c + 3] = val.w;
  }
}

__device__ __forceinline__ void store_row(float* dst, const float (&src)[D], float mul) {
#pragma unroll
  for (int c = 0; c < D4; ++c)
    reinterpret_cast<float4*>(dst)[c] =
        make_float4(src[4 * c] * mul, src[4 * c + 1] * mul, src[4 * c + 2] * mul, src[4 * c + 3] * mul);
}

// sum_d a[d] * row[d], row a tile row in shared memory (all lanes of a warp
// read the same row: broadcast)
__device__ __forceinline__ float dot_row(const float (&a)[D], const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D4; ++c) {
    const float4 w = r4[c];
    acc = fmaf(a[4 * c], w.x, acc);
    acc = fmaf(a[4 * c + 1], w.y, acc);
    acc = fmaf(a[4 * c + 2], w.z, acc);
    acc = fmaf(a[4 * c + 3], w.w, acc);
  }
  return acc;
}

// acc[d] += s * row[d]
__device__ __forceinline__ void axpy_row(float (&acc)[D], float s, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < D4; ++c) {
    const float4 w = r4[c];
    acc[4 * c] = fmaf(s, w.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(s, w.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(s, w.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(s, w.w, acc[4 * c + 3]);
  }
}

// checks shared by the C entry points
inline bool valid_call(int B, int T, int H, int head_dim, int ld) {
  return B >= 1 && B <= 65535 && T >= 1 && T <= 65535 && H >= 1 && H <= 65535 && head_dim == D &&
         ld >= H * D && ld % 4 == 0;
}

}  // namespace attention
