// What B1's bf16 kernels on TMA and wgmma share: the backward's tile
// passes (gated_hifi_bwd_bf16.cu) and the forward (gated_hifi_fwd_bf16.cu),
// which runs the tile passes' stage 1 (expand) as it is. Declared here,
// defined in gated_hifi_bwd_bf16.cu.
#pragma once

#include "gated_hifi_tiles.cuh"
#include "hopper.cuh"

namespace gated_hifi {
namespace bwd16 {

using namespace hopper;

constexpr int TM = 128;                      // frames a tile-pass item
constexpr int KC = 64;                       // channels a k-slice: one 128-byte row

// every map reads boxes of 64 channels: activations [B, T, C] x 128 frames,
// weights 2-D [rows, k] x BN rows
struct TileParams {
  CUtensorMap m_x, m_g, m_a, m_h1, m_dzp, m_dc, m_dz;             // activations
  CUtensorMap m_wall_t, m_ks_t, m_w1_t, m_wg, m_w1, m_ks, m_wall;  // weights: K-major B operands
  const bf16_t *gp, *ball, *cb, *b1;
  const int* lens;
  bf16_t *a, *h1, *u, *dzp16, *dc16, *dz16, *gv, *dx;
  float *zp, *du, *bias;  // zp: zp then dzp in fp32; du: gv Wg^T; bias: the column sums' partials
  int B, T, ntt, nbias;
  float keep;
  Branches br;
  Dropout drop;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the card's SMs (0 where the runtime cannot say)
int sm_count();
// a [B, T, C] bf16 activation map read in boxes of 64 channels x `frames`
bool act_map(CUtensorMap* m, const void* base, int B, int T, int C, int frames);
// a [rows, cols] bf16 weight map read in boxes of 64 columns x `box_rows`
bool weight_map(CUtensorMap* m, const void* base, int rows, int cols, int box_rows);
// launches tile-pass stage S (1 expand, 2 conv, ..., 7 dx) over every item
template <int S>
cudaError_t launch_tiles(const TileParams& p, cudaStream_t s);
// resident blocks per SM of the seven tile stages, the gate's pass and the
// reduction's two kernels, into blocks[0..9]; returns a cudaError_t
int blocks_per_sm(int* blocks);

}  // namespace bwd16
}  // namespace gated_hifi
