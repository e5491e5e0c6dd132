// Shared by the GatedHiFi kernels (gated_hifi_fwd.cu, gated_hifi_bwd.cu,
// through gated_hifi_tiles.cuh): compile-time shapes, the branch table and
// the dropout hash.
//
// Dropout. The mask of an element is a pure function of (seed, sequence b,
// branch d, absolute frame t, channel c), so any tile, forward or backward,
// regenerates the bits of any frame without storing them (the TPU kernel
// keys its hardware PRNG by absolute 128-frame chunk for the same reason,
// ops/pallas/gated_hifi.py:_branch_masks). One 32-bit draw per element
// feeds both dropout sites of the branch: the high 16 bits decide the site
// before the conv, the low 16 bits the site after it, each keeping when
// the field is >= round(p * 2^16). The draw is two rounds of MurmurHash3's
// finalizer over a per-(seed, b, d) key and the counter t*H + c (hash.cuh);
// ops/gated_hifi.py:dropout_bits computes the same bits in torch int64 ops.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace gated_hifi {

constexpr int W = 64;
constexpr int H = 2 * W;
constexpr int TT = 64;     // frames per tile
constexpr int NT = 256;    // threads per block
constexpr int MAX_DEPTH = 8;

struct Branches {
  int depth;
  int k[MAX_DEPTH];
  int dil[MAX_DEPTH];
  int k_off[MAX_DEPTH];  // offset of branch d's [k, H, H] conv kernel in ks
};

// Fills `br` from host arrays; false if a kernel size or dilation is invalid.
inline bool make_branches(int depth, const int* kernels, const int* dilations, Branches* br) {
  if (depth < 1 || depth > MAX_DEPTH) return false;
  *br = Branches{};
  br->depth = depth;
  int off = 0;
  for (int d = 0; d < depth; ++d) {
    if (kernels[d] < 1 || kernels[d] % 2 == 0 || dilations[d] < 1) return false;
    br->k[d] = kernels[d];
    br->dil[d] = dilations[d];
    br->k_off[d] = off;
    off += kernels[d] * H * H;
  }
  return true;
}

__host__ __device__ __forceinline__ uint32_t dropout_key(uint32_t seed, int b, int d) {
  return stream_key(seed, (uint32_t)(b * MAX_DEPTH + d));
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t key, int t, int c) {
  return hash_draw(key, (uint32_t)t * (uint32_t)H + (uint32_t)c);
}

// Dropout of one call: keep when a 16-bit field >= threshold; with
// threshold 0 (p = 0) the stages compute no hash.
struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float scale;  // 1 / (1 - p), as float32
};

}  // namespace gated_hifi
