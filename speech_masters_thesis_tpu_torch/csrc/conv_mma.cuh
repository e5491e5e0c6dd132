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
// bf16 mode (template parameter IO = __nv_bfloat16; float is the 3xTF32
// mode; B5's bf16 forward, enc_layer_fwd.cu): the TPU kernels' bf16
// dot_dtype rounds each product's operands to bf16 and sums in fp32. The
// staging buffers stay fp32: fp32 activations land as they are (cp.async),
// bf16 ones (in_bf16: a kernel's input) and the bf16 weights by 2-byte loads
// converted to fp32, so any width, stride or offset runs; the fragments are
// rounded to bf16 as they are built (bf16_mma.cuh:
// exact for values that were bf16) and go through one m16n8k16 MMA, two
// k-steps of 16 a slice, each k-step's MMAs added to the accumulators in
// fp32 as in the fp32 mode (bf16 mma.sync's accumulation truncates too).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "conv_rows.cuh"
#include "tf32_mma.cuh"

namespace conv_mma {

using bf16_t = __nv_bfloat16;
template <class IO>
constexpr bool kBf16 = std::is_same<IO, bf16_t>::value;

// a pointer into a buffer of IO elements (the packed weights), `elems` past base
template <class IO>
inline float* elems_at(float* base, size_t elems) {
  return reinterpret_cast<float*>(reinterpret_cast<IO*>(base) + elems);
}

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
// stage, in 16-byte pieces (WHOLE: whole_pieces) or 4-byte ones; in the bf16
// mode the weights, and a bf16 input, by 2-byte loads converted to fp32
template <int TN, int EPI, bool WHOLE, int ROWS = 64, int N8 = 4, class IO = float>
__device__ __forceinline__ void load_slice(float* st, const Args& a, const Weight& wb, int s, int slices, int pad,
                                           int r0, int len, size_t row0) {
  using S = Tile<TN, ROWS, N8>;
  constexpr int TM = S::TM;
  constexpr bool BF = kBf16<IO>;
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
    if (BF && a.in_bf16) {
      const bf16_t* src = reinterpret_cast<const bf16_t*>(a.in) + (row0 + t) * a.ldi;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = row && ch + e < a.cin ? __bfloat162float(src[ch + e]) : 0.f;
    } else if (WHOLE) {
      const bool in = row && ch < a.cin;
      tf32::cp_async16(dst, in ? at(ch) : a.in, in ? 16 : 0);
    } else {
      tf32::stage4(dst, [&](int e) -> const float* { return row && ch + e < a.cin ? at(ch + e) : nullptr; });
    }
  }
  if (BF) {  // the bf16 weights
    const bf16_t* wt16 = reinterpret_cast<const bf16_t*>(wb.w) + tap * wb.tap_ld;
    auto wt = [&](size_t i) { return __bfloat162float(wt16[i]); };
    if (wb.nk) {
      for (int f = threadIdx.x; f < TN * (KS / 4); f += NT) {
        const int j = f / (KS / 4), ch = c0 + 4 * (f % (KS / 4));
        int col;
        const bool in = conv_rows::out_column<TN, EPI>(a, j, &col);
        float* dst = bs + j * S::LDB_NK + 4 * (f % (KS / 4));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[e] = in && ch + e < a.cin ? wt((size_t)col * wb.ld + ch + e) : 0.f;
      }
    } else {
      for (int f = threadIdx.x; f < KS * (TN / 4); f += NT) {
        const int k = f / (TN / 4), j = 4 * (f % (TN / 4)), ch = c0 + k;
        float* dst = bs + k * S::LDB_KN + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int col;
          const bool ok = conv_rows::out_column<TN, EPI>(a, j + e, &col) && ch < a.cin;
          dst[e] = ok ? wt((size_t)ch * wb.ld + col) : 0.f;
        }
      }
    }
    return;
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

// The bf16 mode's k-step of 16: acc += A B with A's and B's fp32 values
// rounded to bf16 as the fragments are built (bf16_mma.cuh's m16n8k16
// layout): as at the step's first column, b at this thread's first B
// element (k = 2q, n = g; b_k1 floats to k + 1, b_hi to k + 8, b_nt to the
// next n8 tile)
template <int TN, int ROWS = 64, int N8 = 4>
__device__ __forceinline__ void mma_kstep_bf16(float (&acc)[Tile<TN, ROWS, N8>::MT][N8][4], const float* as,
                                               const float* b, int b_nt, int b_k1, int b_hi, int row0w, int gr,
                                               int qd) {
  using S = Tile<TN, ROWS, N8>;
  uint32_t fa[S::MT][4];
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt) bf16::frag_a(fa[mt], as + (row0w + 16 * mt + gr) * LDA + 2 * qd, LDA);
#pragma unroll
  for (int nt = 0; nt < N8; ++nt) {
    const float* c = b + nt * b_nt;
    const uint32_t fb[2] = {bf16::pack(c[0], c[b_k1]), bf16::pack(c[b_hi], c[b_hi + b_k1])};
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) bf16::mma(acc[mt][nt], fa[mt], fb);
  }
}

template <class Tag, int TAPS, int TN, int EPI, bool WHOLE, int ROWS = 64, int N8 = 4, class IO = float>
__global__ void __launch_bounds__(NT, 2) conv_mma_kernel(const Args a, const Weight wb) {
  using S = Tile<TN, ROWS, N8>;
  constexpr int TM = S::TM;
  constexpr bool BF = kBf16<IO>;
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
    if (s < n) load_slice<TN, EPI, WHOLE, ROWS, N8, IO>(smem + s * S::STAGE, a, wb, s, slices, pad, r0, len, row0);
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
      load_slice<TN, EPI, WHOLE, ROWS, N8, IO>(smem + ((s + STAGES - 1) % STAGES) * S::STAGE, a, wb,
                                               s + STAGES - 1, slices, pad, r0, len, row0);
    tf32::cp_async_commit();
    if (BF) {
      // the B fragment's elements (k = 2q, n = g) in the launch's layout: k + 1 and k + 8 apart
      const float* bs = st + S::A_FLOATS + (wb.nk ? (col0w + gr) * S::LDB_NK + 2 * qd : 2 * qd * S::LDB_KN + col0w + gr);
      const int b_k1 = wb.nk ? 1 : S::LDB_KN;
#pragma unroll 1
      for (int kk = 0; kk < KS / 16; ++kk) {
        float part[S::MT][N8][4] = {};
        mma_kstep_bf16<TN, ROWS, N8>(part, st + 16 * kk, bs + 16 * kk * b_k1, b_nt, b_k1, 8 * b_k1, row0w, gr, qd);
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < N8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
      }
      continue;
    }
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
        const float bv = (a.bias && conv_rows::out_column<TN, EPI>(a, j, &col))
                             ? (BF ? conv_rows::bf16_at(a.bias, col) : a.bias[col])
                             : 0.0f;
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
// the columns' pieces valid or not as a whole (n_out, or GATE's hidden); in
// the bf16 mode only the fp32 activations count (the rest takes 2-byte loads)
template <int EPI, class IO = float>
inline bool whole_pieces(const Args& a, const Weight& wb) {
  using tf32::aligned16;
  if (kBf16<IO> && a.in_bf16) return true;
  const bool in = aligned16(a.in) && a.ldi % 4 == 0 && a.cin % 4 == 0 &&
                  (!a.in2 || (aligned16(a.in2) && a.ldi2 % 4 == 0 && a.split % 4 == 0));
  if (kBf16<IO>) return in;
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
// ROWS x TN tiles of warps N8 n8 tiles wide. IO: the mode (float: 3xTF32,
// bf16: conv_rows.cuh's bf16 mode).
template <class Tag, int TAPS, int TN, int EPI, int ROWS = 64, int N8 = 4, class IO = float>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const Weight wb = weight_of<TAPS>(a);
  if (whole_pieces<EPI, IO>(a, wb))
    return launch_grid<TN, EPI, ROWS, N8>(conv_mma_kernel<Tag, TAPS, TN, EPI, true, ROWS, N8, IO>, a, wb, B,
                                          stream);
  return launch_grid<TN, EPI, ROWS, N8>(conv_mma_kernel<Tag, TAPS, TN, EPI, false, ROWS, N8, IO>, a, wb, B,
                                        stream);
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
