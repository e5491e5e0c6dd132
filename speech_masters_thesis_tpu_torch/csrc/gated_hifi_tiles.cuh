// B1's fp32 tensor-core tile stages, shared by the forward
// (gated_hifi_fwd.cu) and the backward's recompute (gated_hifi_bwd.cu): the
// cp.async staging of k-slices, the products (3xTF32, tf32_mma.cuh), and the
// three stages both directions run, in the same order of products:
//   1 expand   a_d   = relu(x Wall_d + ball_d) * m0_d
//   2 conv     h1_d  = relu(sum_j a_d[t + (j-half) dil] K_d[j] + cb_d) * m1_d
//   3 branch   zp_d  = scale * (h1_d W1_d + b1_d) + x Wall_d + ball_d
// Each stage is one launch over (64-frame tile, sequence, branch) that
// meets the next in a [B, T, depth*H] buffer of device memory. A conv
// tap's operand is 64 consecutive frames of a shifted by the tap's offset,
// so no block holds a halo window: the taps stream through shared memory
// like any other k-slice, and any dilation fits.
//
// Tile: a [64 frames x BN] output (BN = 128 for a branch's columns, 64 for
// the width) of 8 warps, each warp 32 x 32 (or 16 x 32) in m16n8k8 MMAs,
// over k-slices of 32 channels: the activation slice (64 x 32, zero-filled
// outside [0, T)) and the weight slice (32 x BN) are staged by cp.async
// three slices ahead, rows padded to 36 and BN + 8 floats so that fragment
// reads fall on distinct banks. About 80 KB of shared memory and at most
// 128 registers a thread: two blocks (16 warps) per SM. The forward runs
// stages 1-3 with RN (mma_tile): each k-step's products added to the
// accumulators in fp32, because its values reach the VQ-VAE's loss. The
// backward's recompute runs them without (RN cost its tile passes 7%), so
// its a and h1 may differ from the forward's in the last bits and take the
// other side of a relu at a near-tie (chip_smoke phase 7 bounds those).
//
// The stages take the I/O type IO as a template parameter (the fp32
// kernels, their only instances, keep the names their ptxas lines are held
// by in ab_backward.py --ptxas). B1's bf16 mode runs on TMA and wgmma instead
// (gated_hifi_fwd_bf16.cu, gated_hifi_bwd_bf16.cu), which take bf16_t, the
// bf16 loads and stores, the gate's Mix and blocks_per_sm from here.
#pragma once

#include "bf16_mma.cuh"
#include "gated_hifi_common.cuh"
#include "tf32_mma.cuh"

#include <math.h>

namespace gated_hifi {
namespace {

using bf16_t = __nv_bfloat16;

constexpr int KS = 32;          // channels per k-slice
constexpr int STAGES = 3;       // k-slices in flight

template <int BN>
struct TileShape {
  static constexpr int LDB = BN + 8;                  // row stride of a weight slice (elements)
  static constexpr int WARPS_M = BN == 128 ? 2 : 4;   // 8 warps: WARPS_M x (8 / WARPS_M)
  static constexpr int MT = TT / 16 / WARPS_M;        // m16 tiles per warp
};

// The staging of a stage's k-slices: TW the weights' type, TA the
// activation slice's. Rows padded to 36 floats so that 3xTF32's scalar
// fragment reads fall on distinct banks.
template <int BN, class TW, class TA>
struct Staging {
  static constexpr int LDA = KS + 4;  // row stride of an activation slice
  static constexpr int A_BYTES = TT * LDA * (int)sizeof(TA);
  static constexpr int STAGE_BYTES = A_BYTES + KS * TileShape<BN>::LDB * (int)sizeof(TW);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES;
};

// One k-slice: 32 channels of an activation buffer (frame t at a + t*lda,
// read at t + shift, zero outside [0, T)) against 32 rows of a weight
// matrix (b, rows ldb elements apart).
template <class TW, class TA>
struct Slice {
  const TA* a;
  int lda;
  int shift;
  const TW* b;
  int ldb;
};

template <int BN, class TW, class TA>
__device__ __forceinline__ void load_slice(char* st, const Slice<TW, TA>& s, int t0, int T) {
  using G = Staging<BN, TW, TA>;
  constexpr int EA = 16 / sizeof(TA), EB = 16 / sizeof(TW);  // elements a 16-byte copy moves
  TA* as = reinterpret_cast<TA*>(st);
  TW* bs = reinterpret_cast<TW*>(st + G::A_BYTES);
  for (int f = threadIdx.x; f < TT * (KS / EA); f += NT) {
    const int r = f / (KS / EA), c = f % (KS / EA);
    const int t = t0 + r + s.shift;
    const bool in = t >= 0 && t < T;
    tf32::cp_async16(as + r * G::LDA + EA * c, in ? s.a + (size_t)t * s.lda + EA * c : s.a, in ? 16 : 0);
  }
  for (int f = threadIdx.x; f < KS * (BN / EB); f += NT) {
    const int r = f / (BN / EB), c = f % (BN / EB);
    tf32::cp_async16(bs + r * TileShape<BN>::LDB + EB * c, s.b + (size_t)r * s.ldb + EB * c, 16);
  }
}

// The warp's place in the tile: rows row0 + 16*mt + gr (+8), columns
// col0 + 8*nt + 2*qd (+1), as in the accumulator layout.
template <int BN>
struct WarpTile {
  int row0, col0, gr, qd;
  __device__ __forceinline__ WarpTile() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    row0 = (warp % TileShape<BN>::WARPS_M) * 16 * TileShape<BN>::MT;
    col0 = (warp / TileShape<BN>::WARPS_M) * 32;
    gr = lane >> 2;
    qd = lane & 3;
  }
};

// acc += A B over one 8-deep k-step from shared memory: A the tile's 64
// rows (LDA_ elements a row, from the step's first column), B the step's
// rows (TileShape<BN>::LDB elements a row)
template <int BN, int LDA_, class TW, class TA>
__device__ __forceinline__ void mma_kstep(float (&acc)[TileShape<BN>::MT][4][4], const TA* as,
                                          const TW* bs, const WarpTile<BN>& wt) {
  using S = TileShape<BN>;
  tf32::FragA fa[S::MT];
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt) {
    const float* r = as + (wt.row0 + 16 * mt + wt.gr) * LDA_ + wt.qd;
    fa[mt] = tf32::frag_a(r[0], r[8 * LDA_], r[4], r[8 * LDA_ + 4]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float* c = bs + wt.qd * S::LDB + wt.col0 + 8 * nt + wt.gr;
    const tf32::FragB fb = tf32::frag_b(c[0], c[4 * S::LDB]);
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) tf32::mma3(acc[mt][nt], fa[mt], fb);
  }
}

// acc += A B over K channels. RN: each k-step's MMAs go into a part of
// the tile that starts from zero, which is then added to acc in fp32 (round
// to nearest), so at most 3 MMAs meet one tensor-core accumulator. The
// tensor cores' fp32 accumulation truncates each MMA's sum, so with all of
// a conv output's 432 MMAs in one register the forward's error was 8x the
// fp32 FMA kernel's on the card, and the VQ-VAE loss's log-magnitude STFT
// term amplified it into the train step's gradients. The RN k-steps are
// not unrolled into each other: unrolled, the parts of two k-steps stay
// live together and spill at two blocks an SM.
template <int BN, int K, int LDA_, bool RN, class TW, class TA>
__device__ __forceinline__ void mma_tile(float (&acc)[TileShape<BN>::MT][4][4], const TA* as,
                                         const TW* bs, const WarpTile<BN>& wt) {
  using S = TileShape<BN>;
  constexpr int KSTEP = 8, KSTEPS = K / KSTEP;
  if (RN) {
#pragma unroll 1
    for (int kk = 0; kk < KSTEPS; ++kk) {
      float part[S::MT][4][4] = {};
      mma_kstep<BN, LDA_>(part, as + KSTEP * kk, bs + KSTEP * kk * S::LDB, wt);
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) mma_kstep<BN, LDA_>(acc, as + KSTEP * kk, bs + KSTEP * kk * S::LDB, wt);
  }
}

// acc += sum over the n slices slice_of(0 .. n-1) (Slice<TW, TA>), in slice
// order; RN as for mma_tile
template <int BN, bool RN, class TW, class TA, class F>
__device__ __forceinline__ void gemm(float (&acc)[TileShape<BN>::MT][4][4], char* smem, int n, int t0,
                                     int T, F slice_of) {
  using G = Staging<BN, TW, TA>;
  const WarpTile<BN> wt;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load_slice<BN>(smem + s * G::STAGE_BYTES, slice_of(s), t0, T);
    tf32::cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    tf32::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice s has landed, and every warp is done with slice s - 1
    if (s + STAGES - 1 < n)
      load_slice<BN>(smem + ((s + STAGES - 1) % STAGES) * G::STAGE_BYTES, slice_of(s + STAGES - 1), t0, T);
    tf32::cp_async_commit();
    const char* st = smem + (s % STAGES) * G::STAGE_BYTES;
    mma_tile<BN, KS, G::LDA, RN>(acc, reinterpret_cast<const TA*>(st),
                                 reinterpret_cast<const TW*>(st + G::A_BYTES), wt);
  }
  tf32::cp_async_wait<0>();
  __syncthreads();  // the staging buffers are free for the next gemm
}

// f(tile row, tile column, acc[.][.][e], acc[.][.][e + 1]) for each pair of
// adjacent columns the warp holds
template <int BN, class F>
__device__ __forceinline__ void for_pairs(float (&acc)[TileShape<BN>::MT][4][4], F f) {
  const WarpTile<BN> wt;
#pragma unroll
  for (int mt = 0; mt < TileShape<BN>::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(wt.row0 + 16 * mt + wt.gr + 8 * h, wt.col0 + 8 * nt + 2 * wt.qd, acc[mt][nt][2 * h],
          acc[mt][nt][2 * h + 1]);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// rounds each to nearest even
__device__ __forceinline__ void st2(bf16_t* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ float2 ld2(const bf16_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

using bf16::f32;

// 0 or the keep scale of one dropout site (hi: the site before the conv)
__device__ __forceinline__ float site_keep(uint32_t bits, bool hi, const Dropout& drop) {
  return ((hi ? bits >> 16 : bits & 0xFFFFu) >= drop.threshold) ? drop.scale : 0.f;
}

// The gate's softmax over branches at two adjacent channels of one frame:
// zrow is branch 0's zp at the frame's t-half channel c (the s half is W
// further, branch d is d*H further). u = sum_d tanh(t_d) p_d with p_d =
// exp(s_d - m) / den. The forward's output stage and the backward's gate
// stage both take u from here, so they agree bit for bit.
struct Mix {
  float2 tz[MAX_DEPTH], sz[MAX_DEPTH];  // every branch's (t, s) pair, loaded at once
  float m[2], den[2], u[2];
};

__device__ __forceinline__ void mix(Mix& x, const float* zrow, int depth) {
#pragma unroll
  for (int dd = 0; dd < MAX_DEPTH; ++dd) {
    if (dd >= depth) break;
    x.tz[dd] = ld2(zrow + dd * H);
    x.sz[dd] = ld2(zrow + dd * H + W);
  }
  x.m[0] = x.m[1] = -INFINITY;
#pragma unroll
  for (int dd = 0; dd < MAX_DEPTH; ++dd) {
    if (dd >= depth) break;
    x.m[0] = fmaxf(x.m[0], x.sz[dd].x);
    x.m[1] = fmaxf(x.m[1], x.sz[dd].y);
  }
  float num[2] = {0.f, 0.f};
  x.den[0] = x.den[1] = 0.f;
#pragma unroll
  for (int dd = 0; dd < MAX_DEPTH; ++dd) {
    if (dd >= depth) break;
    const float e0 = expf(x.sz[dd].x - x.m[0]), e1 = expf(x.sz[dd].y - x.m[1]);
    x.den[0] += e0;
    x.den[1] += e1;
    num[0] += tanhf(x.tz[dd].x) * e0;
    num[1] += tanhf(x.tz[dd].y) * e1;
  }
  x.u[0] = num[0] / x.den[0];
  x.u[1] = num[1] / x.den[1];
}

// Everything the stages read and write; the buffers are [B, T, depth*H]
// (a, h1, dzp, dc, dz) or [B, T, W] (u, gv, dx, x, g, out). dzp first
// receives the branch outputs zp (stage 3); the backward's gate stage turns
// them into their cotangents in place. IO: the I/O type (float or bf16).
template <class IO>
struct Args {
  const IO *x, *g, *wall, *ball, *ks, *cb, *w1, *b1, *wg, *bg, *wg_t, *w1_t, *ks_t, *wall_t;
  const int* lens;
  IO *a, *h1, *u, *dx, *out;
  float *dzp, *dc, *dz, *gv;
  int T;
  float scale, keep;  // keep: the dropout scale, 1 without dropout
  Branches br;
  Dropout drop;
};

#define TILE_PROLOGUE                                        \
  extern __shared__ __align__(16) float smem_f[];           \
  char* const smem = reinterpret_cast<char*>(smem_f);       \
  const int b = blockIdx.y, d = blockIdx.z;                 \
  const int t0 = blockIdx.x * TT;                           \
  const int T = p.T;                                        \
  const int ldw = p.br.depth * H;                           \
  const size_t row0 = (size_t)b * T;                        \
  (void)d;                                                  \
  (void)ldw

// 1. a_d = relu(x Wall_d + ball_d) * m0_d
template <bool RN, class IO>
__global__ void __launch_bounds__(NT, 2) tile_expand_kernel(const Args<IO> p) {
  TILE_PROLOGUE;
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H, RN, IO, IO>(acc, smem, W / KS, t0, T, [&](int s) {
    return Slice<IO, IO>{p.x + row0 * W + KS * s, W, 0, p.wall + (size_t)KS * s * ldw + d * H, ldw};
  });
  const uint32_t key = p.drop.threshold ? dropout_key(p.drop.seed, b, d) : 0u;
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const int n = d * H + c;
    v0 = fmaxf(v0 + f32(p.ball[n]), 0.f);
    v1 = fmaxf(v1 + f32(p.ball[n + 1]), 0.f);
    if (p.drop.threshold) {
      v0 *= site_keep(dropout_bits(key, t, c), true, p.drop);
      v1 *= site_keep(dropout_bits(key, t, c + 1), true, p.drop);
    }
    st2(p.a + (row0 + t) * ldw + n, v0, v1);
  });
}

// 2. h1_d = relu(sum_j a_d[t + (j-half) dil] K_d[j] + cb_d) * m1_d
template <bool RN, class IO>
__global__ void __launch_bounds__(NT, 2) tile_conv_kernel(const Args<IO> p) {
  TILE_PROLOGUE;
  const int k = p.br.k[d], dil = p.br.dil[d], half = (k - 1) / 2;
  const IO* kd = p.ks + p.br.k_off[d];
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H, RN, IO, IO>(acc, smem, k * (H / KS), t0, T, [&](int s) {
    const int j = s / (H / KS), c = s % (H / KS);
    return Slice<IO, IO>{p.a + row0 * ldw + d * H + KS * c, ldw, (j - half) * dil,
                       kd + (size_t)j * H * H + (size_t)KS * c * H, H};
  });
  const uint32_t key = p.drop.threshold ? dropout_key(p.drop.seed, b, d) : 0u;
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const int n = d * H + c;
    v0 = fmaxf(v0 + f32(p.cb[n]), 0.f);
    v1 = fmaxf(v1 + f32(p.cb[n + 1]), 0.f);
    if (p.drop.threshold) {
      v0 *= site_keep(dropout_bits(key, t, c), false, p.drop);
      v1 *= site_keep(dropout_bits(key, t, c + 1), false, p.drop);
    }
    st2(p.h1 + (row0 + t) * ldw + n, v0, v1);
  });
}

// 3. zp_d = scale * (h1_d W1_d + b1_d) + x Wall_d + ball_d, into dzp
template <bool RN, class IO>
__global__ void __launch_bounds__(NT, 2) tile_branch_kernel(const Args<IO> p) {
  TILE_PROLOGUE;
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H, RN, IO, IO>(acc, smem, H / KS, t0, T, [&](int s) {
    return Slice<IO, IO>{p.h1 + row0 * ldw + d * H + KS * s, ldw, 0,
                       p.w1 + (size_t)d * H * H + (size_t)KS * s * H, H};
  });
  for_pairs<H>(acc, [&](int, int c, float& v0, float& v1) {
    v0 = p.scale * (v0 + f32(p.b1[d * H + c]));
    v1 = p.scale * (v1 + f32(p.b1[d * H + c + 1]));
  });
  gemm<H, RN, IO, IO>(acc, smem, W / KS, t0, T, [&](int s) {
    return Slice<IO, IO>{p.x + row0 * W + KS * s, W, 0, p.wall + (size_t)KS * s * ldw + d * H, ldw};
  });
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const int n = d * H + c;
    st2(p.dzp + (row0 + t) * ldw + n, v0 + f32(p.ball[n]), v1 + f32(p.ball[n + 1]));
  });
}

template <class IO>
using StageKernel = void (*)(const Args<IO>);

// Opts the kernel into `smem` bytes of dynamic shared memory and launches
// it over (64-frame tiles, B, branches).
template <class IO>
inline cudaError_t launch_stage(StageKernel<IO> kernel, size_t smem, const Args<IO>& p, int B, int branches,
                                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.T + TT - 1) / TT, B, branches), NT, smem, s>>>(p);
  return cudaGetLastError();
}

// Resident blocks per SM of a kernel at its launch's threads and shared
// memory (what ptxas's register count and the shared memory allow), or -1.
inline int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  int n = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace
}  // namespace gated_hifi
