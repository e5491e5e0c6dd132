// A row-tiled 1-D convolution on the tensor cores in 3xTF32 (tf32_mma.cuh),
// for the Glow-TTS coupling conditioner's forwards and recompute backwards
// (wn_coupling_{fwd,bwd}.cu, flow_step_{fwd,bwd}.cu through
// wn_coupling_common.cuh) and the text-encoder layer's (enc_layer_{fwd,bwd}.cu
// through enc_layer_common.cuh): conv_rows.cuh's Args and epilogues
// (CONV_ROWS_EPILOGUE), on a grid of (row tile, channel tile, sequence).
//
//   z[b, t, n] = bias[n] + sum_{tap, c} in[b, t + tap * dil - pad, c] * B_tap[c, n]
//
// Each conv tap is a shifted k-slice: a k-slice is KS = 32 input channels of
// the tile's TM consecutive rows read at t + tap * dil - pad (zero outside
// [0, T), past lens[b] when mask_in, and past cin), so no block holds a halo
// window and any dilation fits. Slices are staged three ahead by cp.async, in
// 16-byte pieces when the launch's widths, strides and pointers are
// multiples of 4 floats (whole_pieces: the kernel's WHOLE) and in 4-byte
// ones otherwise (tf32::stage4), so any width, row stride or offset fits. The
// weights come in one of two layouts (Weight): [k][n] rows (n contiguous;
// a 1x1 conv's weight read transposed, or a packed tap-major [taps][cin][n]
// copy, pack_weights_kernel) or [n][k] rows (k contiguous: a 1x1 conv's
// own [n_out, cin] weight). GATE's channel pairs (p, hidden + p) come from
// the loader's column map (conv_rows::out_column).
// ACTNORM_FWD applies the loader's ActNorm to each landed slice in shared
// memory (and writes it to in_out) before its products.
//
// Tile (Tile<TN, ROWS, N8>): TM = ROWS rows by TN columns of 8 warps, each
// MT m16 tiles by N8 n8 tiles in m16n8k8 MMAs: 64 rows by 64 or 128 columns
// (128 for GATE's 64 channel pairs), warps of 16 or 32 rows by 32 columns,
// for B3 and B6 and B5's other products; 16 rows by 192 columns, warps of 16
// by 24, for B5's LayerNorm epilogues, which need a whole 192-channel row in
// one block (LN, LN_BWD). Rows padded to 36 and TN + 8 floats so fragment
// reads fall on distinct banks. At most 90 KB of shared memory and 128
// registers: two blocks an SM. The accumulators go through shared memory
// (over the staging buffers) to the epilogue. Each warp splits the fp32
// operands it reads into their TF32 halves itself: a split once a block
// into shared memory, and 32-row GATE tiles, measured slower for the
// forwards (PERF.md, the forwards' variants).
//
// Numerics: each k-step's three MMAs are added to the accumulators in fp32
// (as gated_hifi_tiles.cuh:mma_tile), because the tensor cores' fp32
// accumulation truncates each MMA's sum; otherwise every MMA of a product
// would meet one register (up to 3 x 240 for a 1,920-deep transposed conv).
//
// The bf16 kernels (B3's, B5's and B6's) run the TMA + wgmma engine of
// bf16_engine.cuh instead.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_rows.cuh"
#include "tf32_mma.cuh"

namespace conv_mma {

using conv_rows::Args;

constexpr int NT = conv_rows::NT;  // 256 threads: the epilogue's
constexpr int KS = 32;             // input channels a k-slice
constexpr int STAGES = 3;          // k-slices in flight
constexpr int LDA = KS + 4;        // row stride of an activation slice

// Where a launch's B operand lives: B_tap[c, n] = w[tap * tap_ld + c * ld + n]
// ([k][n]) or w[tap * tap_ld + n * ld + c] ([n][k], nk set).
struct Weight {
  const float* w;
  long long tap_ld;
  int ld, nk;
};

// A tile of ROWS rows by TN columns: 8 warps of WARPS_M x WARPS_N, each
// N8 n8 tiles wide and MT m16 tiles high
template <int TN, int ROWS = 64, int N8 = 4>
struct Tile {
  static constexpr int TM = ROWS;
  static constexpr int WARPS_N = TN / (8 * N8);
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int MT = TM / 16 / WARPS_M;       // m16 tiles a warp
  static_assert(WARPS_M * WARPS_N == 8 && MT * 16 * WARPS_M == TM, "8 warps of whole m16 and n8 tiles");
  static constexpr int LDB_KN = TN + 8;              // row stride of a [k][n] weight slice
  static constexpr int LDB_NK = KS + 4;              // row stride of an [n][k] weight slice
  static constexpr int A_FLOATS = TM * LDA;
  static constexpr int B_FLOATS = KS * LDB_KN > TN * LDB_NK ? KS * LDB_KN : TN * LDB_NK;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int FLOATS = STAGES * STAGE > TM * (TN + 1) ? STAGES * STAGE : TM * (TN + 1);
  static constexpr size_t SMEM = sizeof(float) * FLOATS;
};

// k-slice s (tap s / slices, channels from 32 * (s % slices)) into one
// stage, in 16-byte pieces (WHOLE: whole_pieces) or 4-byte ones
template <int TN, int EPI, bool WHOLE, int ROWS = 64, int N8 = 4>
__device__ __forceinline__ void load_slice(float* st, const Args& a, const Weight& wb, int s, int slices, int pad,
                                           int r0, int len, size_t row0) {
  using S = Tile<TN, ROWS, N8>;
  constexpr int TM = S::TM;
  const int tap = s / slices, c0 = (s % slices) * KS, shift = tap * a.dil - pad;
  float* as = st;
  float* bs = st + S::A_FLOATS;
  for (int f = threadIdx.x; f < TM * (KS / 4); f += NT) {
    const int r = f / (KS / 4), ch = c0 + 4 * (f % (KS / 4)), t = r0 + r + shift;
    const bool row = t >= 0 && t < a.T && (!a.mask_in || t < len);
    float* dst = as + r * LDA + 4 * (f % (KS / 4));
    auto at = [&](int c) {  // channel c of row t
      return (a.in2 && c >= a.split) ? a.in2 + (row0 + t) * a.ldi2 + (c - a.split) : a.in + (row0 + t) * a.ldi + c;
    };
    if (WHOLE) {
      const bool in = row && ch < a.cin;
      tf32::cp_async16(dst, in ? at(ch) : a.in, in ? 16 : 0);
    } else {
      tf32::stage4(dst, [&](int e) -> const float* { return row && ch + e < a.cin ? at(ch + e) : nullptr; });
    }
  }
  const float* wt = wb.w + tap * wb.tap_ld;
  if (wb.nk) {
    for (int f = threadIdx.x; f < TN * (KS / 4); f += NT) {
      const int j = f / (KS / 4), ch = c0 + 4 * (f % (KS / 4));
      int col;
      const bool in = conv_rows::out_column<TN, EPI>(a, j, &col);
      float* dst = bs + j * S::LDB_NK + 4 * (f % (KS / 4));
      if (WHOLE) {
        const bool ok = in && ch < a.cin;
        tf32::cp_async16(dst, ok ? wt + (size_t)col * wb.ld + ch : wb.w, ok ? 16 : 0);
      } else {
        tf32::stage4(dst, [&](int e) -> const float* {
          return in && ch + e < a.cin ? wt + (size_t)col * wb.ld + ch + e : nullptr;
        });
      }
    }
  } else {
    for (int f = threadIdx.x; f < KS * (TN / 4); f += NT) {
      const int k = f / (TN / 4), j = 4 * (f % (TN / 4)), ch = c0 + k;
      float* dst = bs + k * S::LDB_KN + j;
      if (WHOLE) {
        int col;
        const bool ok = conv_rows::out_column<TN, EPI>(a, j, &col) && ch < a.cin;
        tf32::cp_async16(dst, ok ? wt + (size_t)ch * wb.ld + col : wb.w, ok ? 16 : 0);
      } else {
        tf32::stage4(dst, [&](int e) -> const float* {
          int col;
          return conv_rows::out_column<TN, EPI>(a, j + e, &col) && ch < a.cin ? wt + (size_t)ch * wb.ld + col
                                                                                : nullptr;
        });
      }
    }
  }
}

// ACTNORM_FWD: the loader's ActNorm on a landed slice (one tap), and the
// rows written to in_out by the first channel tile
template <int TM>
__device__ __forceinline__ void actnorm_slice(float* as, const Args& a, int c0, int r0, int len, size_t row0) {
  for (int e = threadIdx.x; e < TM * KS; e += NT) {
    const int r = e / KS, c = e % KS, t = r0 + r, ch = c0 + c;
    if (t >= a.T || ch >= a.cin) continue;
    float x = 0.0f;
    if (!a.mask_in || t < len) x = a.pre_bias[ch] + expf(a.pre_logs[ch]) * as[r * LDA + c];
    as[r * LDA + c] = x;
    if (a.in_out && blockIdx.y == 0) a.in_out[(row0 + t) * a.ldio + ch] = x;
  }
}

// acc += A B over one k-step of 8 from a stage: as at the step's first
// column, b at this thread's first B element of the step (b_nt floats to
// the next n8 tile, b_hi to k + 4: the layout's strides)
template <int TN, int ROWS = 64, int N8 = 4>
__device__ __forceinline__ void mma_kstep(float (&acc)[Tile<TN, ROWS, N8>::MT][N8][4], const float* as,
                                          const float* b, int b_nt, int b_hi, int row0w, int gr, int qd) {
  using S = Tile<TN, ROWS, N8>;
  tf32::FragA fa[S::MT];
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt) {
    const float* r = as + (row0w + 16 * mt + gr) * LDA + qd;
    fa[mt] = tf32::frag_a(r[0], r[8 * LDA], r[4], r[8 * LDA + 4]);
  }
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) {
    const float* c = b + nt * b_nt;
    const tf32::FragB fb = tf32::frag_b(c[0], c[b_hi]);
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) tf32::mma3(acc[mt][nt], fa[mt], fb);
  }
}

template <class Tag, int TAPS, int TN, int EPI, bool WHOLE, int ROWS = 64, int N8 = 4>
__global__ void __launch_bounds__(NT, 2) conv_mma_kernel(const Args a, const Weight wb) {
  using S = Tile<TN, ROWS, N8>;
  constexpr int TM = S::TM;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, r0 = blockIdx.x * TM;
  const int len = a.lens[b];
  const size_t row0 = (size_t)b * a.T;
  const int pad = (TAPS - 1) / 2 * a.dil;
  const int slices = (a.cin + KS - 1) / KS, n = TAPS * slices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0w = (warp % S::WARPS_M) * 16 * S::MT, col0w = (warp / S::WARPS_M) * 8 * N8;
  const int gr = lane >> 2, qd = lane & 3;
  // this thread's B fragment elements in a stage, in the launch's layout
  const int b_base = wb.nk ? (col0w + gr) * S::LDB_NK + qd : qd * S::LDB_KN + col0w + gr;
  const int b_nt = wb.nk ? 8 * S::LDB_NK : 8, b_hi = wb.nk ? 4 : 4 * S::LDB_KN, b_kk = wb.nk ? 8 : 8 * S::LDB_KN;

  float acc[S::MT][N8][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load_slice<TN, EPI, WHOLE, ROWS, N8>(smem + s * S::STAGE, a, wb, s, slices, pad, r0, len, row0);
    tf32::cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    tf32::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice s has landed, and every warp is done with slice s - 1
    float* st = smem + (s % STAGES) * S::STAGE;
    if (EPI == conv_rows::ACTNORM_FWD) {
      actnorm_slice<TM>(st, a, (s % slices) * KS, r0, len, row0);
      __syncthreads();
    }
    if (s + STAGES - 1 < n)
      load_slice<TN, EPI, WHOLE, ROWS, N8>(smem + ((s + STAGES - 1) % STAGES) * S::STAGE, a, wb, s + STAGES - 1,
                                           slices, pad, r0, len, row0);
    tf32::cp_async_commit();
    const float* bs = st + S::A_FLOATS + b_base;
    // each k-step's three MMAs into their own registers, then added to the
    // accumulators in fp32
#pragma unroll 1
    for (int kk = 0; kk < KS / 8; ++kk) {
      float part[S::MT][N8][4] = {};
      mma_kstep<TN, ROWS, N8>(part, st + 8 * kk, bs + kk * b_kk, b_nt, b_hi, row0w, gr, qd);
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < N8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
  }
  tf32::cp_async_wait<0>();
  __syncthreads();  // the staging buffers are free: z goes over them

  float* zs = smem;
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < N8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0w + 16 * mt + gr + 8 * (e / 2), j = col0w + 8 * nt + 2 * qd + e % 2;
        int col;
        const float bv = (a.bias && conv_rows::out_column<TN, EPI>(a, j, &col)) ? a.bias[col] : 0.0f;
        zs[r * (TN + 1) + j] = acc[mt][nt][e] + bv;
      }
  __syncthreads();
  const uint32_t key =
      a.threshold ? stream_key((uint32_t)a.seed[0], (uint32_t)(b * a.stream_mul + a.stream_add)) : 0u;
  using namespace conv_rows;
  constexpr int TR = TM;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  CONV_ROWS_EPILOGUE
}

// The B operand of a launch whose Args carry the weight as the chain sets
// it: a 1x1 conv's own weight ([n_out, cin], or [cin, n_out] read
// transposed with wt), or for TAPS > 1 the packed [TAPS][cin][n_out] copy
// (pack_weights_kernel; tap-flipped there for wt)
template <int TAPS>
inline Weight weight_of(const Args& a) {
  if (TAPS == 1) return a.wt ? Weight{a.w, 0, a.n_out, 0} : Weight{a.w, 0, a.cin, 1};
  return Weight{a.w, (long long)a.cin * a.n_out, a.n_out, 0};
}

// Widths, row strides, `split` and pointers in multiples of 4 floats, and
// the columns' pieces valid or not as a whole (n_out, or GATE's hidden)
template <int EPI>
inline bool whole_pieces(const Args& a, const Weight& wb) {
  using tf32::aligned16;
  const bool in = aligned16(a.in) && a.ldi % 4 == 0 && a.cin % 4 == 0 &&
                  (!a.in2 || (aligned16(a.in2) && a.ldi2 % 4 == 0 && a.split % 4 == 0));
  const bool w = aligned16(wb.w) && wb.ld % 4 == 0 && wb.tap_ld % 4 == 0 &&
                 (wb.nk || (EPI == conv_rows::GATE ? a.hidden : a.n_out) % 4 == 0);
  return in && w;
}

template <int TN, int EPI, int ROWS, int N8, class Kernel>
cudaError_t launch_grid(Kernel kernel, const Args& a, const Weight& wb, int B, cudaStream_t stream) {
  using S = Tile<TN, ROWS, N8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = EPI == conv_rows::GATE ? (a.hidden + TN / 2 - 1) / (TN / 2) : (a.n_out + TN - 1) / TN;
  const dim3 grid((a.T + S::TM - 1) / S::TM, tiles, B);
  kernel<<<grid, NT, S::SMEM, stream>>>(a, wb);
  return cudaGetLastError();
}

// One launch: grid (row tiles, channel tiles, B);
// ROWS x TN tiles of warps N8 n8 tiles wide.
template <class Tag, int TAPS, int TN, int EPI, int ROWS = 64, int N8 = 4>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const Weight wb = weight_of<TAPS>(a);
  if (whole_pieces<EPI>(a, wb))
    return launch_grid<TN, EPI, ROWS, N8>(conv_mma_kernel<Tag, TAPS, TN, EPI, true, ROWS, N8>, a, wb, B, stream);
  return launch_grid<TN, EPI, ROWS, N8>(conv_mma_kernel<Tag, TAPS, TN, EPI, false, ROWS, N8>, a, wb, B, stream);
}

// Resident blocks per SM of a kernel at NT threads and `smem` bytes of
// dynamic shared memory (what its registers and the shared memory allow), or -1.
inline int blocks_per_sm(const void* kernel, size_t smem) {
  int n = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem) != cudaSuccess)
    return -1;
  return n;
}

// A conv's weight [n_out, cin, taps] (PyTorch's Conv1d layout) packed for
// the tensor-core loader as [taps][cin][n_out] (form 0, the conv itself) or
// [taps][n_out][cin] tap-flipped (form 1, its transpose: B_tap[c, n] =
// w[c, n, taps - 1 - tap]), for up to MAX_PACK convs of one shape (a
// conditioner's layers) in one launch: the forms 0 .. FORMS - 1 (1 for a
// forward, 2 for a backward), conv i's form f at dst + (FORMS i + f) * taps
// * n_out * cin.
constexpr int MAX_PACK = 64;

struct Pack {
  const float* src[MAX_PACK];
  float* dst;
  int n_out, cin, taps;
};

template <class Tag, int FORMS>
__global__ void __launch_bounds__(NT) pack_weights_kernel(const Pack p) {
  const int i = blockIdx.y, form = blockIdx.z;
  const int size = p.taps * p.n_out * p.cin;
  const float* src = p.src[i];
  float* dst = p.dst + (size_t)(FORMS * i + form) * size;
  for (int e = blockIdx.x * NT + threadIdx.x; e < size; e += gridDim.x * NT) {
    int tap, c, n, v;
    if (form == 0) {  // dst[tap][c][n] = src[n][c][tap], c < cin, n < n_out
      tap = e / (p.cin * p.n_out);
      c = e / p.n_out % p.cin;
      n = e % p.n_out;
      v = (n * p.cin + c) * p.taps + tap;
    } else {  // dst[tap][c][n] = src[c][n][taps - 1 - tap], c < n_out, n < cin
      tap = e / (p.n_out * p.cin);
      c = e / p.cin % p.n_out;
      n = e % p.cin;
      v = (c * p.cin + n) * p.taps + (p.taps - 1 - tap);
    }
    dst[e] = src[v];
  }
}

template <class Tag, int FORMS>
cudaError_t pack(const float* const* src, int count, float* dst, int n_out, int cin, int taps, cudaStream_t s) {
  static_assert(FORMS == 1 || FORMS == 2, "the conv's form, or both");
  if (count < 1 || count > MAX_PACK) return cudaErrorInvalidValue;
  Pack p{};
  for (int i = 0; i < count; ++i) p.src[i] = src[i];
  p.dst = dst;
  p.n_out = n_out;
  p.cin = cin;
  p.taps = taps;
  const dim3 grid((taps * n_out * cin + 4 * NT - 1) / (4 * NT), count, FORMS);
  pack_weights_kernel<Tag, FORMS><<<grid, NT, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace conv_mma
