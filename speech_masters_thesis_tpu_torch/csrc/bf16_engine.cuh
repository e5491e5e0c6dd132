// The bf16 engine for Hopper (sm_90a) that B3's and B6's bf16 forwards and
// backwards (wn_coupling_bf16.cu) and B5's (enc_layer_bf16.cu) share: the
// k-slice pipeline of a product tile (TMA into an mbarrier ring, wgmma with
// fp32 sums a slice), the weight sums with the frames as wgmma's K
// (wn16_wsum_kernel and its fixed-order reduction), the packing launch
// (wn16_pack_kernel), the bias sums (wn16_bias_kernel) and the host's cache
// of tensor maps (cached_maps). The kernels of the middle three are built
// once, in bf16_engine.cu; each source builds its own product kernels
// around ring_products with the epilogues it needs.
//
// Layout rules (hopper.cuh): operands are bf16 buffers whose rows are a
// multiple of 16 bytes apart (pitch8) on 16-byte aligned bases; every box
// starts on a 128-byte column, since a box whose innermost start is not
// 16-byte aligned faults. A box that reaches past a tensor's frames reads
// zeros there, so a conv tap's shifted slice needs no halo; past a
// sequence's length there is no fill, so every epilogue that writes an
// operand a conv or a weight sum reads writes exact zeros there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "hopper.cuh"

namespace wn16 {

using namespace hopper;
using bf16_t = __nv_bfloat16;

constexpr int TM = 64;          // frames a tile, and a weight-gradient slab
constexpr int KC = 64;          // channels a k-slice: one 128-byte swizzled row
constexpr int RING = 4;         // k-slices in flight
constexpr int THREADS = 128;    // one warpgroup

__host__ __device__ constexpr int pitch8(int c) { return (c + 7) / 8 * 8; }  // a padded row: 16-byte multiple
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}
__device__ __forceinline__ float f32(bf16_t v) { return __bfloat162float(v); }

// Two adjacent elements (the second only when `two`): one 8-byte (fp32) or
// 4-byte (bf16) access where the address allows, else one a element.
__device__ __forceinline__ float2 ld2(const float* p, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 7) == 0) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], two ? p[1] : 0.f);
}
__device__ __forceinline__ float2 ld2(const bf16_t* p, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(f32(p[0]), two ? f32(p[1]) : 0.f);
}
__device__ __forceinline__ void st2(float* p, float a, float b, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}
__device__ __forceinline__ void st2(bf16_t* p, float a, float b, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (two) p[1] = __float2bfloat16_rn(b);
  }
}

// ---- the products ------------------------------------------------------------
// A product tile: 64 frames of one sequence by BN output channels, one
// warpgroup; its lead thread keeps RING k-slices in flight by TMA, each an
// activation box of 64 channels x 64 frames and a weight box of 64 columns x
// BN rows.
constexpr int BN = 64;  // output channels a tile
struct GemmSmem {
  static constexpr int A_BYTES = TM * KC * 2;
  static constexpr int B_BYTES = BN * KC * 2;
  static constexpr int SLOT = A_BYTES + B_BYTES;
  static constexpr int RED_OFF = RING * SLOT;            // column sums: 4 warps x BN floats
  static constexpr int BAR_OFF = RED_OFF + 4 * BN * 4;
  static constexpr int BYTES = BAR_OFF + RING * 8 + 1024;  // + the 1024-byte alignment of the dynamic buffer
  static_assert(SLOT % 1024 == 0 && BYTES <= 232448, "gemm16: swizzled slots, shared memory");
};

// Slice s of a product P (any struct with a[2], w, taps, dil, sign, ch0, ch1,
// a_plane[2], w_plane: out[b, t, n] = sum over taps j and input channels c
// of A[b, t + sign (j - (taps-1)/2) dil, c] W_j[n, c], A the concatenation
// of up to two sources, a[0]'s ch0 64-channel chunks then a[1]'s ch1; the
// weight rows of tap j from plane w_plane + j of w, source 1's columns from
// column 64 ch0) into ring slot k % RING.
template <class P>
__device__ __forceinline__ void load_slice(const P& p, uint8_t* sm, uint64_t* full, int k, int s, int b, int t0,
                                           int n0) {
  const int per_tap = p.ch0 + p.ch1;
  const int j = s / per_tap, u = s % per_tap, q = u < p.ch0 ? 0 : 1, c = q ? u - p.ch0 : u;
  const int shift = p.sign * (j - (p.taps - 1) / 2) * p.dil;
  uint64_t* const f = &full[k % RING];
  uint8_t* const st = sm + (k % RING) * GemmSmem::SLOT;
  mbar_expect_tx(f, GemmSmem::SLOT);
  tma_load_3d(st, &p.a[q], f, KC * c, t0 + shift, p.a_plane[q] + b);
  tma_load_3d(st + GemmSmem::A_BYTES, &p.w, f, KC * (q ? p.ch0 + c : c), n0, p.w_plane + j);
}

// The ring's barriers, set up by the lead thread before any load.
__device__ __forceinline__ void ring_init(uint64_t* full) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// The products of n k-slices, slice k in slot k % RING, its loads issued by
// load(k) (a no-op past the last; the lead thread issues slices 0 .. RING-1
// before this): each slice's four wgmmas start from zero in one of two
// accumulators and are added to the fp32 sums while the next slice's run
// (wgmma's accumulation truncates).
template <class Load>
__device__ __forceinline__ void ring_products(uint8_t* sm, uint64_t* full, int n, Load load, float (&sum)[BN / 2]) {
  const bool lead = threadIdx.x == 0;
  float a0[BN / 2], a1[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) sum[r] = 0.f;
  if (n <= 0) return;
  auto issue = [&](float (&acc)[BN / 2], int s) {
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
    fence_regs(acc);
    mbar_wait(&full[s % RING], (uint32_t)(s / RING) & 1u);
    const uint32_t a_addr = smem_u32(sm + (s % RING) * GemmSmem::SLOT), b_addr = a_addr + GemmSmem::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      mma_k16<BN, 0, 0>(acc, desc_b128(a_addr + 32 * kk, 16, 1024), desc_b128(b_addr + 32 * kk, 16, 1024));
    wgmma_commit();
  };
  auto retire = [&](float (&acc)[BN / 2], int s) {  // slice s's products are done: refill its slot, add them
    fence_regs(acc);
    if (lead) load(s + RING);
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) sum[r] += acc[r];
  };
  issue(a0, 0);
  int s = 1;
  for (; s + 1 < n; s += 2) {
    issue(a1, s);
    wgmma_wait<1>();
    retire(a0, s - 1);
    issue(a0, s + 1);
    wgmma_wait<1>();
    retire(a1, s);
  }
  if (s < n) {
    issue(a1, s);
    wgmma_wait<1>();
    retire(a0, s - 1);
    wgmma_wait<0>();
    retire(a1, s);
  } else {
    wgmma_wait<0>();
    retire(a0, s - 1);
  }
}

// The tile's column sums of v (this thread's accumulator layout: element r
// at column 8 (r / 4) + 2 (lane % 4) + r % 2 of two rows), rows in a fixed
// order, into out[c] for c < limit.
__device__ __forceinline__ void col_sums(const float (&v)[BN / 2], float* red, float* out, int limit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < BN / 8; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[4 * q + e] + v[4 * q + 2 + e];
      s += __shfl_xor_sync(0xFFFFFFFFu, s, 4);
      s += __shfl_xor_sync(0xFFFFFFFFu, s, 8);
      s += __shfl_xor_sync(0xFFFFFFFFu, s, 16);
      if (lane < 4) red[warp * BN + 8 * q + 2 * lane + e] = s;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < BN && c < limit; c += THREADS)
    out[c] = ((red[c] + red[BN + c]) + red[2 * BN + c]) + red[3 * BN + c];
  __syncthreads();
}

// sets a kernel's dynamic shared memory once (a host call a launch otherwise)
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

// ---- the weight gradients (bf16_engine.cu) ------------------------------------------
// out[m sm + n sn] = sum over the frames t of X[t + shift, m] Y[t, n], m < M,
// n < N, X and Y [planes, T, C] bf16 maps (planes xplane + b, yplane + b)
constexpr int W_MAPS = 10;
constexpr int MAX_PROBS = 40;  // a launch's problems (its parameters stay under 4 KB)
constexpr int W_CHUNK = TM * 128;             // bytes of a 64-frame x 64-channel slab
constexpr int W_SLOT = 3 * W_CHUNK;           // X's chunk, then Y's two
constexpr int W_BAR_OFF = RING * W_SLOT;
constexpr int W_SMEM = W_BAR_OFF + RING * 8 + 1024;
constexpr int FLUSH = 4;                      // slabs between two adds of the accumulators into fp32 sums
constexpr int JOB_FLOATS = 64 * 128;

struct WProb {
  void* out;
  int sm, sn, shift, xplane, yplane, block0;  // block0: the problem's first block
  int16_t M, N, mchunks, ntiles;
  int8_t xmap, ymap, f32, pad;
};

// a problem (pointer `out` may be null when only the blocks are wanted)
inline WProb wprob(void* out, int f32, int xmap, int xplane, int shift, int M, int ymap, int yplane, int N, int sm,
                   int sn) {
  WProb q{};
  q.out = out;
  q.f32 = (int8_t)f32;
  q.xmap = (int8_t)xmap;
  q.ymap = (int8_t)ymap;
  q.xplane = xplane;
  q.yplane = yplane;
  q.shift = shift;
  q.M = (int16_t)M;
  q.N = (int16_t)N;
  q.mchunks = (int16_t)cdiv(M, KC);
  q.ntiles = (int16_t)cdiv(N, 128);
  q.sm = sm;
  q.sn = sn;
  return q;
}

// the SMs of the current device (0 where the runtime cannot say)
int sm_count();

// the problems' launches (at most MAX_PROBS each) with their blocks
// assigned, over B sequences of T frames; returns the frame split and the
// largest launch's blocks
int assign(std::vector<WProb>& v, int B, int T, long long* most_blocks);

// every problem's sums, their shares' partials in `part` (JOB_FLOATS a block
// of the largest launch where the frames are split)
cudaError_t weight_sums(std::vector<WProb> v, int B, int T, const CUtensorMap (&maps)[W_MAPS], float* part,
                        cudaStream_t s);

// ---- packing (bf16_engine.cu) -----------------------------------------------------------
// dst[(j * rows + r) * pitch + c] for planes j, rows r, columns c: the
// source's element src[j s_plane + r' s_row + c s_col] (r' = r, or GATE's
// row order), zero where r' >= src_rows or c >= src_cols; P_ACTNORM and
// P_MASKED take the rows as the frames of [B, T] and zero the rows at or
// past a sequence's length (P_ACTNORM first maps v to alb + exp(aln) v)
enum Pack : int { P_BF16, P_F32, P_GATE, P_ACTNORM, P_MASKED };
constexpr int MAX_JOBS = 32;

struct PackJob {
  const void* src;
  bf16_t* dst;
  long long s_plane, s_row, s_col;
  int planes, rows, cols, pitch, src_rows, src_cols, kind, H;
};

struct PackParams {
  PackJob job[MAX_JOBS];
  int n, T;
  const int* lens;
  const float *aln, *alb;
};

cudaError_t pack(std::vector<PackJob>& jobs, const int* lens, int T, const float* aln, const float* alb,
                 cudaStream_t s);

// ---- column sums (bf16_engine.cu) ------------------------------------------------------
// The bias, gain and table gradients: for each source, t[c] = the sum over
// its rows i of row i's column c (c < width), fp32 partial rows or bf16
// rows `ld` elements apart, each column in one fixed order (32 strides of
// 32 rows, then their 32 sums in order); bf16(t) written to every output
// and t itself to out32 where given. No float atomics.
struct SumSource {
  const float* part;  // fp32 rows, or null for bf16 rows `in`
  const bf16_t* in;
  int rows, width, ld;
  std::vector<bf16_t*> outs;
  float* out32;
};

cudaError_t column_sums(const std::vector<SumSource>& sources, cudaStream_t s);

// A call's maps, from a cache of the last few calls' (the caching allocator
// hands a wrapper the same scratch call after call, and encoding the maps
// is a large part of a call's host time). The key holds every pointer and
// size a map reads, its padding zeroed: keys compare as bytes. One cache
// per call site; host calls come from one thread.
template <class Key, class M, class Encode>
inline bool cached_maps(const Key& key, M* m, Encode encode) {
  struct Entry {
    Key key;
    M maps;
  };
  static std::vector<Entry> cache;
  static size_t next = 0;
  for (const Entry& e : cache)
    if (memcmp(&e.key, &key, sizeof(Key)) == 0) {
      *m = e.maps;
      return true;
    }
  if (!encode(m)) return false;
  constexpr size_t SLOTS = 8;
  if (cache.size() < SLOTS) {
    cache.push_back(Entry{key, *m});
  } else {
    cache[next] = Entry{key, *m};
    next = (next + 1) % SLOTS;
  }
  return true;
}

// a [planes, T, C] activation map (rows `pitch` elements apart) in boxes of 64 channels x 64 frames
inline bool act_map(CUtensorMap* m, const bf16_t* base, int C, int T, int planes, int pitch) {
  return bf16_map(m, base, C, T, planes, (uint64_t)pitch * 2, (uint64_t)T * pitch * 2, KC, TM);
}
inline bool act_map(CUtensorMap* m, const bf16_t* base, int C, int T, int planes) {
  return act_map(m, base, C, T, planes, pitch8(C));
}

// a [planes, N, K] weight map (K-major rows) in boxes of 64 columns x box_rows
inline bool w_map(CUtensorMap* m, const bf16_t* base, int K, int N, int planes, int box_rows) {
  return bf16_map(m, base, K, N, planes, (uint64_t)pitch8(K) * 2, (uint64_t)N * pitch8(K) * 2, KC, box_rows);
}

}  // namespace wn16
