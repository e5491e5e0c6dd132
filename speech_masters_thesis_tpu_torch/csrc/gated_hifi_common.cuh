// Shared by the GatedHiFi kernels (gated_hifi_fwd.cu, gated_hifi_bwd.cu):
// compile-time shapes, the branch table, the dropout hash, and the forward's
// fp32 tile stages (the backward's tile passes run on the tensor cores,
// gated_hifi_bwd.cu).
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
constexpr int XS = W + 1;  // padded row strides (bank-conflict-free row reads)
constexpr int AS = H + 1;

struct Branches {
  int depth;
  int max_halo;
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
    const int halo = (kernels[d] - 1) / 2 * dilations[d];
    br->max_halo = halo > br->max_halo ? halo : br->max_halo;
  }
  return true;
}

// x window and expand buffer of a tile: (TT + 2*max_halo) rows of each
inline size_t tile_smem_bytes(int max_halo) {
  const size_t rows = TT + 2 * (size_t)max_halo;
  return sizeof(float) * rows * (XS + AS);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[j] += v * (w0, w1)[j] for the 8 columns of two float4s
__device__ __forceinline__ void fma8(float (&acc)[8], float v, float4 w0, float4 w1) {
  acc[0] = fmaf(v, w0.x, acc[0]);
  acc[1] = fmaf(v, w0.y, acc[1]);
  acc[2] = fmaf(v, w0.z, acc[2]);
  acc[3] = fmaf(v, w0.w, acc[3]);
  acc[4] = fmaf(v, w1.x, acc[4]);
  acc[5] = fmaf(v, w1.y, acc[5]);
  acc[6] = fmaf(v, w1.z, acc[6]);
  acc[7] = fmaf(v, w1.w, acc[7]);
}

// acc[j] += v * w[j] for the 4 columns of a float4
__device__ __forceinline__ void fma4(float (&acc)[4], float v, float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

__host__ __device__ __forceinline__ uint32_t dropout_key(uint32_t seed, int b, int d) {
  return stream_key(seed, (uint32_t)(b * MAX_DEPTH + d));
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t key, int t, int c) {
  return hash_draw(key, (uint32_t)t * (uint32_t)H + (uint32_t)c);
}

// Dropout of one call: keep when a 16-bit field >= threshold; threshold 0
// (p = 0) launches the kernels' instantiation without dropout.
struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float scale;  // 1 / (1 - p), as float32
};

// ---- the forward kernel's tile stages (fp32 FMA on the CUDA cores) --------
// A thread owns rows rg + 16*i (i < 4) and, in H-wide stages, the 8 columns
// n8..n8+7, in W-wide stages the 4 columns n4..n4+3 (see the kernels).

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Branch d's expand over window rows [0, Rd) (absolute frame t_first + r):
// as[r] = relu(xs[xoff + r] W_d + b_d) * m0, zero outside [0, T). With
// a_out (the [B, T, depth*H] buffer at this sequence, branch and n8), the
// centre rows [halo, halo + TT) inside [0, T) are also stored there.
template <bool DROP>
__device__ __forceinline__ void expand_tile(float* as, const float* xs, const float* wall,
                                            const float* ball, int d, int ldw, int Rd, int xoff,
                                            int t_first, int halo, int T, uint32_t key,
                                            const Dropout& drop, int rg, int n8, float* a_out) {
  const float* wd = wall + d * H + n8;
  for (int r0 = 0; r0 < Rd; r0 += TT) {
    float acc[4][8] = {};
#pragma unroll 8
    for (int c = 0; c < W; ++c) {
      const float4 w0 = ld4(wd + (size_t)c * ldw), w1v = ld4(wd + (size_t)c * ldw + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + rg + 16 * i;
        fma8(acc[i], r < Rd ? xs[(xoff + r) * XS + c] : 0.f, w0, w1v);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + rg + 16 * i;
      if (r >= Rd) continue;
      const int t = t_first + r;
      const bool inside = t >= 0 && t < T;
      float a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[j] = inside ? fmaxf(acc[i][j] + ball[d * H + n8 + j], 0.f) : 0.f;
        if (DROP && inside)
          a[j] *= (dropout_bits(key, t, n8 + j) >> 16) >= drop.threshold ? drop.scale : 0.f;
        as[r * AS + n8 + j] = a[j];
      }
      if (a_out != nullptr && r >= halo && r < halo + TT && inside) {
        float* dst = a_out + (size_t)t * ldw;
        st4(dst, a[0], a[1], a[2], a[3]);
        st4(dst + 4, a[4], a[5], a[6], a[7]);
      }
    }
  }
}

// acc[i][.] += sum_j sum_c as[first_row + 16*i + j*step][c] * K[j][c][n8 + .]
// for the k taps of K ([k, H, H], offset to column n8): the dilated conv
// (first_row = rg, step = dil) and its transpose (rg + 2*halo, -dil).
__device__ __forceinline__ void conv_tile(float (&acc)[4][8], const float* as, const float* kd,
                                          int k, int first_row, int step) {
  for (int j = 0; j < k; ++j) {
    const float* arow = as + (first_row + j * step) * AS;
    const float* kj = kd + (size_t)j * H * H;
#pragma unroll 8
    for (int c = 0; c < H; ++c) {
      const float4 w0 = ld4(kj + (size_t)c * H), w1v = ld4(kj + (size_t)c * H + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) fma8(acc[i], arow[16 * i * AS + c], w0, w1v);
    }
  }
}

// Branch d's output at the centre rows, t and s halves paired:
// tv/sv = x W_d + b_d + scale * (h1 W1_d + b1_d), h1 in as rows [0, TT),
// x in xs rows [max_halo, max_halo + TT).
__device__ __forceinline__ void branch_out_tile(float (&tv)[4][4], float (&sv)[4][4],
                                                const float* as, const float* xs, const float* wall,
                                                const float* ball, const float* w1, const float* b1,
                                                int d, int ldw, int max_halo, float scale, int rg,
                                                int n4) {
  float zt[4][4] = {}, zs[4][4] = {};
  const float* w1d = w1 + (size_t)d * H * H;
#pragma unroll 8
  for (int c = 0; c < H; ++c) {
    const float4 wt = ld4(w1d + (size_t)c * H + n4), wsv = ld4(w1d + (size_t)c * H + W + n4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float h = as[(rg + 16 * i) * AS + c];
      fma4(zt[i], h, wt);
      fma4(zs[i], h, wsv);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      zt[i][j] = scale * (zt[i][j] + b1[d * H + n4 + j]);
      zs[i][j] = scale * (zs[i][j] + b1[d * H + W + n4 + j]);
    }
  const float* wd = wall + d * H;
#pragma unroll 8
  for (int c = 0; c < W; ++c) {
    const float4 wt = ld4(wd + (size_t)c * ldw + n4), wsv = ld4(wd + (size_t)c * ldw + W + n4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xv = xs[(max_halo + rg + 16 * i) * XS + c];
      fma4(zt[i], xv, wt);
      fma4(zs[i], xv, wsv);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tv[i][j] = zt[i][j] + ball[d * H + n4 + j];
      sv[i][j] = zs[i][j] + ball[d * H + W + n4 + j];
    }
}

}  // namespace gated_hifi
