// The 32-bit hash behind the kernels' dropout masks (ops/hash.py computes
// the same bits in torch int64 ops). A mask element is a pure function of
// (seed, stream, counter), so a tile of any kernel, forward or backward,
// regenerates the bits it needs without storing them.
#pragma once

#include <stdint.h>

// MurmurHash3's 32-bit finalizer
__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the key of stream `stream` (>= 0) under `seed`
__host__ __device__ __forceinline__ uint32_t stream_key(uint32_t seed, uint32_t stream) {
  return fmix32(fmix32(seed) + (stream + 1u) * 0x9E3779B9u);
}

// one 32-bit draw for `counter` of a stream
__host__ __device__ __forceinline__ uint32_t hash_draw(uint32_t key, uint32_t counter) {
  return fmix32(fmix32(key ^ counter) + key);
}
