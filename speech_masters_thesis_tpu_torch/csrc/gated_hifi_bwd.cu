// GatedHiFi block backward for Hopper (sm_90a), fp32 at its interface, the
// tile passes' products in 3xTF32 on the tensor cores (tf32_mma.cuh), with
// the dropout masks regenerated from the seed.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/gated_hifi.py, function
// _vjp_bwd -> _bwd -> _bwd_kernel (the TPU kernel's recompute backward).
// Like it, this saves no residuals beyond x, lens, the weights and the
// seed: the forward is recomputed from x. What it computes, with the
// forward's names (gated_hifi_fwd.cu) and g the output's cotangent:
//   gv    = scale * g * [t < min(T, len)]             (d v)
//   du    = gv Wg^T;  dWg = u^T gv;  dbg = sum gv
//   dzp_d = [du p_d (1 - tanh^2 t_d),  du p_d (tanh t_d - u)]
//   dc_d  = scale * (dzp_d W1_d^T) * m1_d * [c_d > 0];  dW1_d = scale h1_d^T dzp_d
//   dK_d[j] = sum_t a_d[t + (j-half) dil]^T dc_d[t];     dcb_d = sum dc_d
//   dz_d  = dzp_d + (sum_j dc_d[t - (j-half) dil] K_d[j]^T) * m0_d * [z_d > 0]
//   dWall = x^T dz;  dx = g * [t < min(T, len)] + dz Wall^T
//
// Two things of the TPU kernel do not carry over to Hopper:
//  1. Its window. The TPU tile holds centre +- 2*halo of every branch in
//     VMEM so that one grid step produces dx. Branch 4's halo of 108 frames
//     would make that window 496 frames here, 254 KB for one branch's
//     expand alone, over the 227 KB a block may have. So the backward's
//     tile passes are stages that meet in device memory, in the buffers the
//     weight gradients need anyway (ops/gated_hifi.py:BackwardBuffers):
//       1 expand   a_d   = relu(x Wall_d + ball_d) * m0_d
//       2 conv     h1_d  = relu(sum_j a_d[t + (j-half) dil] K_d[j] + cb_d) * m1_d
//       3 branch   zp_d  = scale * (h1_d W1_d + b1_d) + x Wall_d + ball_d  (into dzp)
//       4 gate     du = gv Wg^T; u, gv and dzp_d from zp_d in place
//       5 dc       dc_d  = scale * (dzp_d W1_d^T) * m1 * [c > 0]
//       6 convt    dz_d  = dzp_d + (sum_j dc_d[t - (j-half) dil] K_d[j]^T) * m0 * [z > 0]
//       7 dx       dx    = g' + dz Wall^T
//     Each stage is one launch over (64-frame tile, sequence, branch). A
//     conv tap's operand is 64 consecutive frames of a (or dc) shifted by
//     the tap's offset, so no block holds a halo window: the taps stream
//     through shared memory like any other k-slice. The a and dc windows
//     are read once per tap, from L2 for the neighbours' rows.
//  2. Its weight gradients. The TPU accumulates them across its sequential
//     grid (@pl.when(first) ... += ...). Hopper's blocks run in parallel
//     and in no order, so every weight gradient is a product summed over
//     the B*T frames, computed as a split-over-time reduction: each block of
//     wgrad_partial_kernel sums one slice of the frames for one product
//     (one conv tap of one branch, a branch 1x1, the gate, or a branch's
//     slice of the expand) into its own partial, and wgrad_reduce_kernel
//     adds the slices in a fixed order. No float atomics: equal inputs give
//     bitwise-equal gradients.
//
// What bounds the tile passes: arithmetic. They cost twice the forward's
// multiply-adds (the recompute, then the transposed products), about 2
// MFLOP a frame, 3x that on the tensor cores in 3xTF32; the stages move
// about 15 [B, T, depth*H] passes of device memory. At 16 x 33024 that is
// 16 GB (4.7 ms at 3.35 TB/s) against 3.2 TFLOP of TF32 products (6.5 ms
// at 495 TF/s); these stages reach about a quarter of that rate.
// Design: every stage is a [64 frames x BN] output tile (BN = 128 for a
// branch's columns, 64 for the width) of 8 warps, each warp 32 x 32 (or
// 16 x 32) in m16n8k8 MMAs, over k-slices of 32 channels: the activation
// slice (64 x 32, zero-filled outside [0, T)) and the weight slice
// (32 x BN) are staged by cp.async three slices ahead, rows padded to 36
// and BN + 8 floats so that fragment reads fall on distinct banks. About
// 80 KB of shared memory and at most 128 registers a thread: two blocks
// (16 warps) per SM. The epilogues apply bias, relu, the dropout masks (the
// same hash as the forward, bit for bit) and the gating, and write the
// buffers. The weight-gradient reduction is plain fp32 FMA on the CUDA
// cores, 128 x 128 tiles with 8 x 8 a thread over 16-frame slabs.

#include "gated_hifi_common.cuh"
#include "tf32_mma.cuh"

#include <math.h>

#include <vector>

namespace gated_hifi {
namespace {

// ---- the tile passes: a [TT x BN] output tile over streamed k-slices ------
constexpr int KS = 32;          // channels per k-slice
constexpr int STAGES = 3;       // k-slices in flight
constexpr int LDA = KS + 4;     // row stride of an activation slice

template <int BN>
struct TileShape {
  static constexpr int LDB = BN + 8;                  // row stride of a weight slice
  static constexpr int WARPS_M = BN == 128 ? 2 : 4;   // 8 warps: WARPS_M x (8 / WARPS_M)
  static constexpr int MT = TT / 16 / WARPS_M;        // m16 tiles per warp
  static constexpr int STAGE_FLOATS = TT * LDA + KS * LDB;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE_FLOATS;
};

// One k-slice: 32 channels of an activation buffer (frame t at a + t*lda,
// read at t + shift, zero outside [0, T)) against 32 rows of a weight
// matrix (b, rows ldb floats apart).
struct Slice {
  const float* a;
  int lda;
  int shift;
  const float* b;
  int ldb;
};

template <int BN>
__device__ __forceinline__ void load_slice(float* st, const Slice& s, int t0, int T) {
  float* as = st;
  float* bs = st + TT * LDA;
  for (int f = threadIdx.x; f < TT * (KS / 4); f += NT) {
    const int r = f / (KS / 4), c4 = f % (KS / 4);
    const int t = t0 + r + s.shift;
    const bool in = t >= 0 && t < T;
    tf32::cp_async16(as + r * LDA + 4 * c4, in ? s.a + (size_t)t * s.lda + 4 * c4 : s.a, in ? 16 : 0);
  }
  for (int f = threadIdx.x; f < KS * (BN / 4); f += NT) {
    const int r = f / (BN / 4), c4 = f % (BN / 4);
    tf32::cp_async16(bs + r * TileShape<BN>::LDB + 4 * c4, s.b + (size_t)r * s.ldb + 4 * c4, 16);
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

// acc += sum over the n slices slice_of(0 .. n-1), in slice order
template <int BN, class F>
__device__ __forceinline__ void gemm(float (&acc)[TileShape<BN>::MT][4][4], float* smem, int n, int t0,
                                     int T, F slice_of) {
  using S = TileShape<BN>;
  const WarpTile<BN> wt;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load_slice<BN>(smem + s * S::STAGE_FLOATS, slice_of(s), t0, T);
    tf32::cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    tf32::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice s has landed, and every warp is done with slice s - 1
    if (s + STAGES - 1 < n)
      load_slice<BN>(smem + ((s + STAGES - 1) % STAGES) * S::STAGE_FLOATS, slice_of(s + STAGES - 1), t0, T);
    tf32::cp_async_commit();
    const float* as = smem + (s % STAGES) * S::STAGE_FLOATS;
    const float* bs = as + TT * LDA;
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk) {
      tf32::FragA fa[S::MT];
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt) {
        const float* r = as + (wt.row0 + 16 * mt + wt.gr) * LDA + 8 * kk + wt.qd;
        fa[mt] = tf32::frag_a(r[0], r[8 * LDA], r[4], r[8 * LDA + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* c = bs + (8 * kk + wt.qd) * S::LDB + wt.col0 + 8 * nt + wt.gr;
        const tf32::FragB fb = tf32::frag_b(c[0], c[4 * S::LDB]);
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt) tf32::mma3(acc[mt][nt], fa[mt], fb);
      }
    }
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

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// 0 or the keep scale of one dropout site (hi: the site before the conv)
__device__ __forceinline__ float site_keep(uint32_t bits, bool hi, const Dropout& drop) {
  return ((hi ? bits >> 16 : bits & 0xFFFFu) >= drop.threshold) ? drop.scale : 0.f;
}

// Everything the stages read and write; the buffers are [B, T, depth*H]
// (a, h1, dzp, dc, dz) or [B, T, W] (u, gv, dx, x, g).
struct Args {
  const float *x, *g, *wall, *ball, *ks, *cb, *w1, *b1, *wg_t, *w1_t, *ks_t, *wall_t;
  const int* lens;
  float *a, *h1, *dzp, *dc, *dz, *u, *gv, *dx;
  int T;
  float scale, keep;  // keep: the dropout scale, 1 without dropout
  Branches br;
  Dropout drop;
};

#define TILE_PROLOGUE                                        \
  extern __shared__ __align__(16) float smem[];             \
  const int b = blockIdx.y, d = blockIdx.z;                 \
  const int t0 = blockIdx.x * TT;                           \
  const int T = p.T;                                        \
  const int ldw = p.br.depth * H;                           \
  const size_t row0 = (size_t)b * T;                        \
  (void)d;                                                  \
  (void)ldw

// 1. a_d = relu(x Wall_d + ball_d) * m0_d
__global__ void __launch_bounds__(NT, 2) tile_expand_kernel(const Args p) {
  TILE_PROLOGUE;
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H>(acc, smem, W / KS, t0, T, [&](int s) {
    return Slice{p.x + row0 * W + KS * s, W, 0, p.wall + (size_t)KS * s * ldw + d * H, ldw};
  });
  const uint32_t key = p.drop.threshold ? dropout_key(p.drop.seed, b, d) : 0u;
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const int n = d * H + c;
    v0 = fmaxf(v0 + p.ball[n], 0.f);
    v1 = fmaxf(v1 + p.ball[n + 1], 0.f);
    if (p.drop.threshold) {
      v0 *= site_keep(dropout_bits(key, t, c), true, p.drop);
      v1 *= site_keep(dropout_bits(key, t, c + 1), true, p.drop);
    }
    st2(p.a + (row0 + t) * ldw + n, v0, v1);
  });
}

// 2. h1_d = relu(sum_j a_d[t + (j-half) dil] K_d[j] + cb_d) * m1_d
__global__ void __launch_bounds__(NT, 2) tile_conv_kernel(const Args p) {
  TILE_PROLOGUE;
  const int k = p.br.k[d], dil = p.br.dil[d], half = (k - 1) / 2;
  const float* kd = p.ks + p.br.k_off[d];
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H>(acc, smem, k * (H / KS), t0, T, [&](int s) {
    const int j = s / (H / KS), c = s % (H / KS);
    return Slice{p.a + row0 * ldw + d * H + KS * c, ldw, (j - half) * dil,
                 kd + (size_t)j * H * H + (size_t)KS * c * H, H};
  });
  const uint32_t key = p.drop.threshold ? dropout_key(p.drop.seed, b, d) : 0u;
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const int n = d * H + c;
    v0 = fmaxf(v0 + p.cb[n], 0.f);
    v1 = fmaxf(v1 + p.cb[n + 1], 0.f);
    if (p.drop.threshold) {
      v0 *= site_keep(dropout_bits(key, t, c), false, p.drop);
      v1 *= site_keep(dropout_bits(key, t, c + 1), false, p.drop);
    }
    st2(p.h1 + (row0 + t) * ldw + n, v0, v1);
  });
}

// 3. zp_d = scale * (h1_d W1_d + b1_d) + x Wall_d + ball_d, into dzp
__global__ void __launch_bounds__(NT, 2) tile_branch_kernel(const Args p) {
  TILE_PROLOGUE;
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H>(acc, smem, H / KS, t0, T, [&](int s) {
    return Slice{p.h1 + row0 * ldw + d * H + KS * s, ldw, 0,
                 p.w1 + (size_t)d * H * H + (size_t)KS * s * H, H};
  });
  for_pairs<H>(acc, [&](int, int c, float& v0, float& v1) {
    v0 = p.scale * (v0 + p.b1[d * H + c]);
    v1 = p.scale * (v1 + p.b1[d * H + c + 1]);
  });
  gemm<H>(acc, smem, W / KS, t0, T, [&](int s) {
    return Slice{p.x + row0 * W + KS * s, W, 0, p.wall + (size_t)KS * s * ldw + d * H, ldw};
  });
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const int n = d * H + c;
    st2(p.dzp + (row0 + t) * ldw + n, v0 + p.ball[n], v1 + p.ball[n + 1]);
  });
}

// 4. du = gv Wg^T, then gv, u and dzp_d (from zp_d, in place), element by
// element: the softmax over branches of the s halves, tanh of the t halves
__global__ void __launch_bounds__(NT, 2) tile_gate_kernel(const Args p) {
  TILE_PROLOGUE;
  float acc[TileShape<W>::MT][4][4] = {};
  gemm<W>(acc, smem, W / KS, t0, T, [&](int s) {
    return Slice{p.g + row0 * W + KS * s, W, 0, p.wg_t + (size_t)KS * s * W, W};
  });
  const int len = min(T, p.lens[b]);
  const int depth = p.br.depth;
  for_pairs<W>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const bool valid = t < len;
    const float2 gg = ld2(p.g + (row0 + t) * W + c);
    st2(p.gv + (row0 + t) * W + c, valid ? p.scale * gg.x : 0.f, valid ? p.scale * gg.y : 0.f);
    const float du[2] = {valid ? p.scale * v0 : 0.f, valid ? p.scale * v1 : 0.f};
    float* zrow = p.dzp + (row0 + t) * ldw + c;
    float2 tz[MAX_DEPTH], sz[MAX_DEPTH];  // every branch's (t, s) pair, loaded at once
#pragma unroll
    for (int dd = 0; dd < MAX_DEPTH; ++dd) {
      if (dd >= depth) break;
      tz[dd] = ld2(zrow + dd * H);
      sz[dd] = ld2(zrow + dd * H + W);
    }
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int dd = 0; dd < MAX_DEPTH; ++dd) {
      if (dd >= depth) break;
      m[0] = fmaxf(m[0], sz[dd].x);
      m[1] = fmaxf(m[1], sz[dd].y);
    }
    float den[2] = {0.f, 0.f}, num[2] = {0.f, 0.f};
#pragma unroll
    for (int dd = 0; dd < MAX_DEPTH; ++dd) {
      if (dd >= depth) break;
      const float e0 = expf(sz[dd].x - m[0]), e1 = expf(sz[dd].y - m[1]);
      den[0] += e0;
      den[1] += e1;
      num[0] += tanhf(tz[dd].x) * e0;
      num[1] += tanhf(tz[dd].y) * e1;
    }
    const float u[2] = {num[0] / den[0], num[1] / den[1]};
    st2(p.u + (row0 + t) * W + c, u[0], u[1]);
#pragma unroll
    for (int dd = 0; dd < MAX_DEPTH; ++dd) {
      if (dd >= depth) break;
      const float tv[2] = {tz[dd].x, tz[dd].y}, sv[2] = {sz[dd].x, sz[dd].y};
      float dt[2], ds[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float th = tanhf(tv[j]);
        const float pj = expf(sv[j] - m[j]) / den[j];
        dt[j] = du[j] * pj * (1.f - th * th);
        ds[j] = du[j] * pj * (th - u[j]);
      }
      st2(zrow + dd * H, dt[0], dt[1]);
      st2(zrow + dd * H + W, ds[0], ds[1]);
    }
  });
}

// 5. dc_d = scale * (dzp_d W1_d^T) * m1 * [c > 0]  (h1 > 0 exactly there)
__global__ void __launch_bounds__(NT, 2) tile_dc_kernel(const Args p) {
  TILE_PROLOGUE;
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H>(acc, smem, H / KS, t0, T, [&](int s) {
    return Slice{p.dzp + row0 * ldw + d * H + KS * s, ldw, 0,
                 p.w1_t + (size_t)d * H * H + (size_t)KS * s * H, H};
  });
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const size_t idx = (row0 + t) * ldw + d * H + c;
    const float2 h = ld2(p.h1 + idx);
    st2(p.dc + idx, h.x > 0.f ? p.scale * v0 * p.keep : 0.f, h.y > 0.f ? p.scale * v1 * p.keep : 0.f);
  });
}

// 6. dz_d = dzp_d + (sum_j dc_d[t - (j-half) dil] K_d[j]^T) * m0 * [z > 0]
// (a = relu(z) * m0 > 0 exactly there)
__global__ void __launch_bounds__(NT, 2) tile_convt_kernel(const Args p) {
  TILE_PROLOGUE;
  const int k = p.br.k[d], dil = p.br.dil[d], half = (k - 1) / 2;
  const float* kd = p.ks_t + p.br.k_off[d];
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H>(acc, smem, k * (H / KS), t0, T, [&](int s) {
    const int j = s / (H / KS), c = s % (H / KS);
    return Slice{p.dc + row0 * ldw + d * H + KS * c, ldw, -(j - half) * dil,
                 kd + (size_t)j * H * H + (size_t)KS * c * H, H};
  });
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const size_t idx = (row0 + t) * ldw + d * H + c;
    const float2 z = ld2(p.dzp + idx), av = ld2(p.a + idx);
    st2(p.dz + idx, z.x + (av.x > 0.f ? v0 * p.keep : 0.f), z.y + (av.y > 0.f ? v1 * p.keep : 0.f));
  });
}

// 7. dx = g * [t < len] + dz Wall^T
__global__ void __launch_bounds__(NT, 2) tile_dx_kernel(const Args p) {
  TILE_PROLOGUE;
  float acc[TileShape<W>::MT][4][4] = {};
  gemm<W>(acc, smem, ldw / KS, t0, T, [&](int s) {
    return Slice{p.dz + row0 * ldw + KS * s, ldw, 0, p.wall_t + (size_t)KS * s * W, W};
  });
  const int len = min(T, p.lens[b]);
  for_pairs<W>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const float2 gg = t < len ? ld2(p.g + (row0 + t) * W + c) : make_float2(0.f, 0.f);
    st2(p.dx + (row0 + t) * W + c, v0 + gg.x, v1 + gg.y);
  });
}

#undef TILE_PROLOGUE

template <int BN>
cudaError_t launch_stage(void (*kernel)(const Args), const Args& p, int B, int branches, cudaStream_t s) {
  const size_t smem = TileShape<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.T + TT - 1) / TT, B, branches), NT, smem, s>>>(p);
  return cudaGetLastError();
}

// ---- weight gradients: split-over-time reduction ---------------------------
constexpr int WG_TILE = 128;       // out tile: M, N <= 128
constexpr int WG_ROWS = 16;        // frames per shared-memory slab
constexpr int WG_PART = (WG_TILE + 1) * WG_TILE;  // a partial: the tile and its column sums
constexpr int WG_MAX_PROBLEMS = 48;

// out_w[m, n] (+)= scale * sum_r X[r + shift, m] * Y[r, n] over the B*T frames r
// (X zero where t + shift leaves [0, T)); out_b[n] = scale * sum_r Y[r, n].
struct WgradProblem {
  const float* X;
  const float* Y;
  float* out_w;
  float* out_b;  // nullptr: no column sums
  int ldx, ldy, ldo, shift, M, N;
  float scale;
};

struct WgradBatch {
  WgradProblem p[WG_MAX_PROBLEMS];
};

__global__ void __launch_bounds__(NT) wgrad_partial_kernel(
    const WgradBatch batch, int p0, float* __restrict__ partials, int B, int T, int n_split) {
  __shared__ __align__(16) float xsl[WG_ROWS][WG_TILE];
  __shared__ __align__(16) float ysl[WG_ROWS][WG_TILE];
  const WgradProblem pr = batch.p[blockIdx.y];
  const int s = blockIdx.x;
  const long long rows = (long long)B * T;
  const long long chunk = (rows + n_split - 1) / n_split;
  const long long r_begin = s * chunk;
  const long long r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4 (+64), columns tx*4 (+64) of the tile

  float acc[8][8] = {};
  float colsum = 0.f;  // column tid's sum of Y, tid < WG_TILE
  for (long long r0 = r_begin; r0 < r_end; r0 += WG_ROWS) {
    for (int q = tid; q < WG_ROWS * WG_TILE / 4; q += NT) {
      const int rr = q / (WG_TILE / 4), c4 = (q % (WG_TILE / 4)) * 4;
      const long long r = r0 + rr;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
      if (r < r_end) {
        const int ts = (int)(r % T) + pr.shift;
        if (c4 < pr.N) yv = *reinterpret_cast<const float4*>(pr.Y + r * pr.ldy + c4);
        if (c4 < pr.M && ts >= 0 && ts < T)
          xv = *reinterpret_cast<const float4*>(pr.X + (r + pr.shift) * pr.ldx + c4);
      }
      *reinterpret_cast<float4*>(&xsl[rr][c4]) = xv;
      *reinterpret_cast<float4*>(&ysl[rr][c4]) = yv;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < WG_ROWS; ++rr) {
      const float4 xa = *reinterpret_cast<const float4*>(&xsl[rr][ty * 4]);
      const float4 xb = *reinterpret_cast<const float4*>(&xsl[rr][64 + ty * 4]);
      const float4 ya = *reinterpret_cast<const float4*>(&ysl[rr][tx * 4]);
      const float4 yb = *reinterpret_cast<const float4*>(&ysl[rr][64 + tx * 4]);
      const float xm[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float yn[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xm[i], yn[j], acc[i][j]);
      if (tid < WG_TILE) colsum += ysl[rr][tid];
    }
    __syncthreads();
  }

  float* out = partials + ((size_t)(p0 + blockIdx.y) * n_split + s) * WG_PART;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    *reinterpret_cast<float4*>(out + m * WG_TILE + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + m * WG_TILE + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (tid < WG_TILE) out[WG_TILE * WG_TILE + tid] = colsum;
}

__global__ void __launch_bounds__(NT) wgrad_reduce_kernel(
    const WgradBatch batch, int p0, const float* __restrict__ partials, int n_split) {
  const WgradProblem pr = batch.p[blockIdx.y];
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= WG_PART) return;
  const int m = e / WG_TILE, n = e % WG_TILE;
  if (n >= pr.N || (m < WG_TILE && m >= pr.M) || (m == WG_TILE && pr.out_b == nullptr)) return;
  const float* src = partials + (size_t)(p0 + blockIdx.y) * n_split * WG_PART + e;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += src[(size_t)s * WG_PART];  // fixed order
  sum *= pr.scale;
  if (m == WG_TILE)
    pr.out_b[n] = sum;
  else
    pr.out_w[(size_t)m * pr.ldo + n] = sum;
}

int wgrad_problem_count(const Branches& br) {
  int taps = 0;
  for (int d = 0; d < br.depth; ++d) taps += br.k[d];
  return taps + 2 * br.depth + 1;  // conv taps, branch 1x1s, gate, expand slices
}

}  // namespace
}  // namespace gated_hifi

// Launches the tile passes' seven stages on `stream`; returns a cudaError_t
// (0 on success). Inputs as for gated_hifi_fwd, plus g [B, T, width] (the
// output's cotangent) and the transposed weights: wg_t [W(out), W(in)], w1_t
// [depth, H(out), H(in)], ks_t the branches' [k_d, H(out), H(in)] back to
// back, wall_t [depth*H, W]. Outputs: a, h1, dzp, dc, dz [B, T, depth*H];
// u, gv, dx [B, T, width].
extern "C" int gated_hifi_bwd(const float* x, const int* lens, const float* g, const float* wall,
                              const float* ball, const float* ks, const float* cb, const float* w1,
                              const float* b1, const float* wg_t, const float* w1_t,
                              const float* ks_t, const float* wall_t, float* a, float* h1,
                              float* dzp, float* dc, float* dz, float* u, float* gv, float* dx,
                              int B, int T, int width, int depth, const int* kernels,
                              const int* dilations, float scale, unsigned seed,
                              unsigned threshold, float keep_scale, void* stream) {
  using namespace gated_hifi;
  Branches br;
  if (width != W || B < 1 || B > 65535 || T < 1 || !make_branches(depth, kernels, dilations, &br))
    return (int)cudaErrorInvalidValue;
  const Args p{x,  g,  wall, ball, ks, cb, w1, b1, wg_t, w1_t, ks_t, wall_t, lens,
               a,  h1, dzp,  dc,   dz, u,  gv, dx, T,    scale, threshold ? keep_scale : 1.f,
               br, Dropout{seed, threshold, keep_scale}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // in stream order: each stage reads what the ones before it wrote
  cudaError_t err = launch_stage<H>(tile_expand_kernel, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage<H>(tile_conv_kernel, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage<H>(tile_branch_kernel, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage<W>(tile_gate_kernel, p, B, 1, s);
  if (err == cudaSuccess) err = launch_stage<H>(tile_dc_kernel, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage<H>(tile_convt_kernel, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage<W>(tile_dx_kernel, p, B, 1, s);
  return (int)err;
}


// Floats of the partials buffer gated_hifi_wgrad needs.
extern "C" long gated_hifi_wgrad_partial_floats(int depth, const int* kernels, int n_split) {
  using namespace gated_hifi;
  std::vector<int> dil(depth > 0 ? depth : 1, 1);
  Branches br;
  if (!make_branches(depth, kernels, dil.data(), &br) || n_split < 1) return -1;
  return (long)wgrad_problem_count(br) * n_split * WG_PART;
}

// Weight gradients from the tile passes' buffers, into `grads`: the packed
// layout wall | ball | ks | cb | w1 | b1 | wg | bg of gated_hifi_fwd's
// weights. Each gradient is split over n_split slices of the B*T frames
// into `partials`, then summed in slice order.
extern "C" int gated_hifi_wgrad(const float* x, const float* a, const float* h1, const float* dzp,
                                const float* dc, const float* dz, const float* u, const float* gv,
                                float* partials, float* grads, int B, int T, int width, int depth,
                                const int* kernels, const int* dilations, float scale,
                                int n_split, void* stream) {
  using namespace gated_hifi;
  Branches br;
  if (width != W || B < 1 || T < 1 || n_split < 1 || !make_branches(depth, kernels, dilations, &br))
    return (int)cudaErrorInvalidValue;
  const int ldb = depth * H;
  int taps = 0;
  for (int d = 0; d < depth; ++d) taps += br.k[d];
  float* dwall = grads;
  float* dball = dwall + W * ldb;
  float* dks = dball + ldb;
  float* dcb = dks + (size_t)taps * H * H;
  float* dw1 = dcb + ldb;
  float* db1 = dw1 + (size_t)depth * H * H;
  float* dwg = db1 + ldb;
  float* dbg = dwg + W * W;

  std::vector<WgradProblem> probs;
  for (int d = 0; d < depth; ++d) {
    const int half = (br.k[d] - 1) / 2;
    for (int j = 0; j < br.k[d]; ++j)
      probs.push_back({a + d * H, dc + d * H, dks + br.k_off[d] + (size_t)j * H * H,
                       j == 0 ? dcb + d * H : nullptr, ldb, ldb, H, (j - half) * br.dil[d], H, H,
                       1.f});
  }
  for (int d = 0; d < depth; ++d)
    probs.push_back({h1 + d * H, dzp + d * H, dw1 + (size_t)d * H * H, db1 + d * H, ldb, ldb, H,
                     0, H, H, scale});
  probs.push_back({u, gv, dwg, dbg, W, W, W, 0, W, W, 1.f});
  for (int d = 0; d < depth; ++d)
    probs.push_back({x, dz + d * H, dwall + d * H, dball + d * H, W, ldb, ldb, 0, W, H, 1.f});

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int p0 = 0; p0 < (int)probs.size(); p0 += WG_MAX_PROBLEMS) {
    const int left = (int)probs.size() - p0;
    const int n = left < WG_MAX_PROBLEMS ? left : WG_MAX_PROBLEMS;
    WgradBatch batch{};
    for (int i = 0; i < n; ++i) batch.p[i] = probs[p0 + i];
    wgrad_partial_kernel<<<dim3(n_split, n), NT, 0, s>>>(batch, p0, partials, B, T, n_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wgrad_reduce_kernel<<<dim3((WG_PART + NT - 1) / NT, n), NT, 0, s>>>(batch, p0, partials, n_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
