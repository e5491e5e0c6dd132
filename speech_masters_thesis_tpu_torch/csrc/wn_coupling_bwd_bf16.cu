// The Glow-TTS coupling conditioner's recompute backward in bf16 for Hopper
// (sm_90a), on one engine for B3 (wn_coupling_bwd_bf16) and the whole flow
// step, B6 (flow_step_bwd_bf16): every product on wgmma with both operands
// bf16, staged by TMA into mbarrier rings (hopper.cuh), fp32 sums. The fp32
// modes stay in wn_coupling_bwd.cu and flow_step_bwd.cu.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, functions
// _vjp_bwd -> _bwd -> pallas_call(_bwd_kernel) (body _conditioner_bwd) and
// _flow_vjp_bwd -> _bwd_flow -> pallas_call(_bwd_flow_kernel), in their bf16
// mode (dot_dtype bf16). Plain versions: ops/wn_coupling.py:
// wn_coupling_backward_reference, ops/flow_step.py:
// flow_step_backward_reference. Rounding points, as the TPU kernel's: every
// product's operands bf16 (_dot), fp32 sums; the gate's derivative, the
// residual chains of h and dh, the skip sum and the ActNorm fp32; dx0 (B3)
// and dx (B6) written in bf16; the conditioner's weight gradients fp32 sums
// over every frame cast to bf16 once, dmt, daln and dalb fp32.
//
// What it computes, for the output cotangent g [B, T, c_out] (B6: g_out,
// and g_xc of xc):
//   B6's prefix: x1 = (alb + exp(aln) x) * valid, x0 = (x1 mt)[:, :half]
//   recompute: h_0 = (x0 W_s^T + b_s) * valid; per layer i
//     x_in_i = (conv_k(h_i, W_in_i) + b_in_i) * keep_i
//     acts_i = tanh(x_in_i[:, :H]) * sigmoid(x_in_i[:, H:])
//     rs = acts_i W_rs_i^T + b_rs_i: h_{i+1} = (h_i + rs[:, :H]) * valid,
//     skip += rs[:, H:] (the last layer's rs is all skip)
//   dskip = (g W_end) * valid; per layer i in reverse, drs = [dh_{i+1}, dskip]
//   (dskip alone for the last):
//     dacts = drs W_rs_i, dx_in = [dacts s (1 - t^2), dacts t s (1 - s)] * keep_i
//     dh_i = (dh_{i+1} + conv_k^T(dx_in, W_in_i)) * valid
//   B3: dx0 = dh_0 W_s * valid. B6: dxc = [g_xc[:, :half] + dh_0 W_s,
//   g_xc[:, half:]] * valid, dx1 = dxc mt^T * valid, dx = dx1 exp(aln),
//   dmt = x1^T dxc, daln = sum dx x, dalb = sum dx1.
//   Weight gradients X^T Y over the B * T frames: W_s (x0, dh_0), W_in_i
//   (h_i shifted by each tap, dx_in_i), W_rs_i (acts_i, drs), W_end (skip *
//   valid, g); the biases: dbend sums g over all frames, dbs, dbrs, dbin the
//   fp32 cotangents dh_0, drs, dx_in.
//
// What bounds it on an H100: operations. At Glow's width (H 192, half 80,
// k 5, 4 layers) a frame costs about 7.9 MFLOP (the recompute, the
// transposed products and the weight products, 3x the forward), 24 GFLOP
// at (8, 384): 0.024 ms at 989 TFLOP/s of bf16; the inputs and outputs move
// about 1 KB a frame.
//
// Design. The TPU kernel keeps a sequence and its per-layer scratch in VMEM.
// Here the scratch lives in device memory, laid out by the wrapper
// (ops/wn_coupling.py:bwd16_layout, one allocation): the operands the
// products read in bf16 (exact copies: the TPU kernel rounds them as
// operands anyway), rows padded to 16 bytes so TMA can read them, and the
// values fp32 work reads in fp32 (x_in for the gate's derivative, h and dh
// for the residual chains, the skip sum). One launch packs every weight
// K-major in the layout its product reads and the caller's x0 and g (any
// row stride or offset) into padded bf16 buffers; B6's also forms x1 (the
// ActNorm) and dxc's second half. Every product is then one launch of
// wn16_gemm_kernel<EPI>: a block computes 64 frames of one sequence by 64
// output channels, one warpgroup whose lead thread keeps RING k-slices in
// flight by TMA (an activation slice of 64 channels x 64 frames through a
// 3-D map over [layers * B, T, C], a conv tap's shift as its frame
// coordinate, so the copy fills zeros outside [0, T) of its own sequence;
// the weight slice from a 3-D map over [layers * taps, N, K]; every box
// starts on a 128-byte column: a start that is not 16-byte aligned faults).
// Each k-slice's four wgmmas start from zero in one of two accumulators and
// are added to fp32 sums while the next slice's run (wgmma's accumulation
// truncates, and the gate conv sums 960 terms, the transposed conv 1,920).
// The epilogues run in the accumulators' layout, two adjacent columns a
// thread, their fp32 inputs (x_in, h, the skip sum, dh) loaded before the
// products: the gate (the conv's weight rows packed 32 tanh then 32 sigmoid
// channels, so both halves of a channel sit in one thread), the residual
// and skip updates, the gate's derivative with the regenerated masks, the
// residual add of dh, and the column sums of the fp32 cotangents that the
// bias gradients need (one fixed-order partial row a tile). Every epilogue
// that writes an operand the convs read (h, dx_in, dh) writes exact zeros
// past the lengths. The weight gradients are wn16_wsum_kernel: a block
// computes 64 x 128 outputs of one problem over the frames (the frames as
// wgmma's K, both operands MN-major as they lie in device memory, fp32 sums
// every FLUSH slabs) and writes them in the gradient's own layout and
// dtype; where the jobs are too few to fill the card, over a fixed share of
// the frames, and wn16_wsum_reduce_kernel adds the shares in a fixed order.
// wn16_bias_kernel adds the bias partials. No float atomics: two calls are
// bitwise equal. Launches a call at Glow's shape (4 layers): B3 22 (a pack,
// 1 + 2 L recompute products, 1 + 2 L transposed, dx0, the weight sums, the
// biases), B6 24 (x1 mt and dx1 = dxc mt^T more).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <string.h>

#include <vector>

#include "hash.cuh"
#include "hopper.cuh"

namespace wn16 {

using namespace hopper;
using bf16_t = __nv_bfloat16;

constexpr int WN_STREAMS = 64;  // ops/wn_coupling.py WN_STREAMS: hash streams a sequence, one a layer
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
enum Epi : int { START, GATE, RES, DSKIP, GATE_BWD, CONVT, DX0, DXC, XC, DX1 };

// One product out[b, t, n] = sum over taps j and input channels c of
// A[b, t + sign (j - (taps-1)/2) dil, c] W_j[n, c], A the concatenation of up
// to two sources (a[0]'s channels, then a[1]'s); its weight rows come from
// planes w_plane + j of `w`, source 1's columns from column 64 ch0 (so every
// box starts on a 128-byte column).
struct Gemm {
  CUtensorMap a[2], w;
  int taps, dil, sign, ch0, ch1;  // ch0, ch1: 64-channel chunks of the two sources
  int a_plane[2], w_plane;
  int B, T, ntt, H, n_out;
  const int* lens;
  const long long* seed;
  unsigned threshold;
  float keep_scale;
  int layer, first, last;
  const bf16_t* bias;
  float* f0;  // fp32 state: h (START, RES), x_in (GATE, GATE_BWD), dh (CONVT)
  float* f1;  // RES: the skip sum
  bf16_t* o0;  // the bf16 output (rows ld0 apart)
  bf16_t* o1;  // RES of the last layer: skip * valid
  int ld0, ld1;
  const bf16_t* r16;  // DXC: g_xc, DX1: x (rows ldr apart)
  int ldr;
  const float* aln;   // DX1
  float* part;        // column sums' partials: row = the tile's, part_ld floats a row
  float* part2;
  int part_ld;
};

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

// rows of W_in's conv form: per 32 channels, their tanh rows then their sigmoid rows
__host__ __device__ constexpr int gate_rows(int H) { return 2 * 32 * cdiv(H, 32); }

__device__ __forceinline__ float drop(const Gemm& p, uint32_t key, int t, int c) {
  if (!p.threshold) return 1.0f;
  return hash_draw(key, (uint32_t)t * (uint32_t)(2 * p.H) + (uint32_t)c) >= p.threshold ? p.keep_scale : 0.0f;
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

template <int EPI>
__global__ void __launch_bounds__(THREADS) wn16_gemm_kernel(const __grid_constant__ Gemm p) {
  using S = GemmSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + S::BAR_OFF);
  float* const red = reinterpret_cast<float*>(sm + S::RED_OFF);
  const int b = blockIdx.x / p.ntt, t0 = (blockIdx.x % p.ntt) * TM, n0 = blockIdx.y * BN;
  const int per_tap = p.ch0 + p.ch1, ns = p.taps * per_tap;
  const bool lead = threadIdx.x == 0;
  if (lead) {
    for (int i = 0; i < RING; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto load = [&](int s) {
    if (s >= ns) return;
    const int j = s / per_tap, u = s % per_tap, q = u < p.ch0 ? 0 : 1, c = q ? u - p.ch0 : u;
    const int shift = p.sign * (j - (p.taps - 1) / 2) * p.dil;
    uint64_t* const f = &full[s % RING];
    uint8_t* const st = sm + (s % RING) * S::SLOT;
    mbar_expect_tx(f, S::SLOT);
    tma_load_3d(st, &p.a[q], f, KC * c, t0 + shift, p.a_plane[q] + b);
    tma_load_3d(st + S::A_BYTES, &p.w, f, KC * (q ? p.ch0 + c : c), n0, p.w_plane + j);
  };
  if (lead)
    for (int s = 0; s < RING; ++s) load(s);

  // The epilogue's coordinates: sum[r] is row 16 warp + lane / 4 + 8 ((r / 2) % 2), column 8 (r / 4) +
  // 2 (lane % 4) + r % 2, so a thread's registers r, r + 1 (r even) are two adjacent columns of one row,
  // read and written as a pair
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int len = min(p.lens[b], p.T);
  const size_t base = (size_t)b * p.T;
  auto row_of = [&](int r) { return t0 + row0 + 8 * ((r >> 1) & 1); };
  auto col_of = [&](int r) { return 8 * (r >> 2) + col0; };
  const int H = p.H;

  // The values the epilogue reads from device memory, loaded before the products so that their latency
  // hides behind them: x_in's two halves (GATE_BWD), h or the skip sum before this layer (RES), dh_{i+1}
  // (CONVT), x (DX1), g_xc (DXC).
  float pre[BN / 2], pre2[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; r += 2) {
    pre[r] = pre[r + 1] = pre2[r] = pre2[r + 1] = 0.f;
    const int t = row_of(r), n = n0 + col_of(r), lim = EPI == GATE_BWD ? H : p.n_out;
    if (t >= p.T || n >= lim) continue;
    const bool two = n + 1 < lim;
    const size_t row = base + t;
    float2 v = make_float2(0.f, 0.f), w = make_float2(0.f, 0.f);
    if constexpr (EPI == GATE_BWD) {
      if (t < len) {
        v = ld2(p.f0 + row * 2 * H + n, two);
        w = ld2(p.f0 + row * 2 * H + H + n, two);
      }
    } else if constexpr (EPI == RES) {
      auto old = [&](int m) {
        if (!p.last && m < H) return p.f0[row * H + m];
        return p.first ? 0.f : p.f1[row * H + (p.last ? m : m - H)];
      };
      v = make_float2(old(n), two ? old(n + 1) : 0.f);
    } else if constexpr (EPI == CONVT) {
      if (!p.last) v = ld2(p.f0 + row * H + n, two);
    } else if constexpr (EPI == DX1 || EPI == DXC) {
      v = ld2(p.r16 + row * p.ldr + n, two);
    }
    pre[r] = v.x;
    pre[r + 1] = v.y;
    pre2[r] = w.x;
    pre2[r + 1] = w.y;
  }

  // Each k-slice's 4 wgmmas start from zero in one of two accumulators and
  // are added to the fp32 sums while the next slice's run.
  float sum[BN / 2], a0[BN / 2], a1[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) sum[r] = 0.f;
  auto issue = [&](float (&acc)[BN / 2], int s) {
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
    fence_regs(acc);
    mbar_wait(&full[s % RING], (uint32_t)(s / RING) & 1u);
    const uint32_t a_addr = smem_u32(sm + (s % RING) * S::SLOT), b_addr = a_addr + S::A_BYTES;
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
  for (; s + 1 < ns; s += 2) {
    issue(a1, s);
    wgmma_wait<1>();
    retire(a0, s - 1);
    issue(a0, s + 1);
    wgmma_wait<1>();
    retire(a1, s);
  }
  if (s < ns) {
    issue(a1, s);
    wgmma_wait<1>();
    retire(a0, s - 1);
    wgmma_wait<0>();
    retire(a1, s);
  } else {
    wgmma_wait<0>();
    retire(a0, s - 1);
  }

  // ---- epilogue
  const uint32_t key = p.threshold ? stream_key((uint32_t)p.seed[0], (uint32_t)(b * WN_STREAMS + p.layer)) : 0u;

  if constexpr (EPI == GATE) {
    // the weight rows of column tile y: 32 tanh channels 32 y + c, then their 32 sigmoid channels H + 32 y + c
#pragma unroll
    for (int r = 0; r < BN / 4; r += 2) {
      const int t = row_of(r), c = 32 * blockIdx.y + col_of(r);
      if (t >= p.T || c >= H) continue;
      const bool two = c + 1 < H;
      const size_t row = base + t;
      float zt[2], zg[2], a[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ce = two ? c + e : c;
        zt[e] = (sum[r + e] + f32(p.bias[ce])) * drop(p, key, t, ce);
        zg[e] = (sum[r + BN / 4 + e] + f32(p.bias[H + ce])) * drop(p, key, t, H + ce);
        a[e] = tanhf(zt[e]) * (1.0f / (1.0f + expf(-zg[e])));
      }
      st2(p.f0 + row * 2 * H + c, zt[0], zt[1], two);
      st2(p.f0 + row * 2 * H + H + c, zg[0], zg[1], two);
      st2(p.o0 + row * p.ld0 + c, a[0], a[1], two);
    }
  } else if constexpr (EPI == RES) {
    // columns < H of a layer before the last: the residual stream h; the rest: the skip sum
#pragma unroll
    for (int r = 0; r < BN / 2; r += 2) {
      const int t = row_of(r), n = n0 + col_of(r);
      if (t >= p.T || n >= p.n_out) continue;
      const bool two = n + 1 < p.n_out;
      const size_t row = base + t;
      const float valid = t < len ? 1.0f : 0.0f;
      const float rs0 = sum[r] + f32(p.bias[n]), rs1 = two ? sum[r + 1] + f32(p.bias[n + 1]) : 0.0f;
      // pre: h, or the skip sum before this layer (0 for the first)
      auto residual = [&](int m, float a, float b2, float h0, float h1, bool both) {
        const float v0 = (h0 + a) * valid, v1 = (h1 + b2) * valid;
        st2(p.f0 + row * H + m, v0, v1, both);
        st2(p.o0 + row * p.ld0 + m, v0, v1, both);
      };
      auto skip = [&](int k, float a, float b2, float o0, float o1, bool both) {
        const float s0 = p.first ? a : o0 + a, s1 = p.first ? b2 : o1 + b2;
        st2(p.f1 + row * H + k, s0, s1, both);
        if (p.last) st2(p.o1 + row * p.ld1 + k, s0 * valid, s1 * valid, both);
      };
      if (p.last) {
        skip(n, rs0, rs1, pre[r], pre[r + 1], two);
      } else if (n >= H) {
        skip(n - H, rs0, rs1, pre[r], pre[r + 1], two);
      } else if (!two || n + 1 < H) {
        residual(n, rs0, rs1, pre[r], pre[r + 1], two);
      } else {  // columns H - 1 and H: one of each (H odd)
        residual(n, rs0, 0.f, pre[r], 0.f, false);
        skip(0, rs1, 0.f, pre[r + 1], 0.f, false);
      }
    }
  } else if constexpr (EPI == GATE_BWD) {
    float dt[BN / 2], dg[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; r += 2) {
      const int t = row_of(r), c = n0 + col_of(r);
      dt[r] = dg[r] = dt[r + 1] = dg[r + 1] = 0.f;
      if (t >= p.T || c >= H) continue;
      const bool two = c + 1 < H;
      const size_t row = base + t;
      if (t < len) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e == 1 && !two) break;
          const float th = tanhf(pre[r + e]), sg = 1.0f / (1.0f + expf(-pre2[r + e]));
          dt[r + e] = sum[r + e] * sg * (1.0f - th * th) * drop(p, key, t, c + e);
          dg[r + e] = sum[r + e] * th * sg * (1.0f - sg) * drop(p, key, t, H + c + e);
        }
      }
      st2(p.o0 + row * p.ld0 + c, dt[r], dt[r + 1], two);
      st2(p.o0 + row * p.ld0 + H + c, dg[r], dg[r + 1], two);
    }
    float* const part = p.part + (size_t)blockIdx.x * p.part_ld;
    col_sums(dt, red, part + n0, H - n0);
    col_sums(dg, red, part + H + n0, H - n0);
  } else if constexpr (EPI == DX1) {
    // dx1 * valid, dx = that * exp(aln) in bf16; the partials of daln (dx x) and dalb (dx1 * valid)
    float da[BN / 2], db[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; r += 2) {
      const int t = row_of(r), c = n0 + col_of(r);
      da[r] = db[r] = da[r + 1] = db[r + 1] = 0.f;
      if (t >= p.T || c >= p.n_out) continue;
      const bool two = c + 1 < p.n_out;
      const size_t row = base + t;
      const float2 x = make_float2(pre[r], pre[r + 1]);
      const float v0 = t < len ? sum[r] : 0.0f, v1 = t < len && two ? sum[r + 1] : 0.0f;
      const float d0 = v0 * expf(p.aln[c]), d1 = two ? v1 * expf(p.aln[c + 1]) : 0.0f;
      st2(p.o0 + row * p.ld0 + c, d0, d1, two);
      da[r] = d0 * x.x;
      da[r + 1] = d1 * x.y;
      db[r] = v0;
      db[r + 1] = v1;
    }
    col_sums(da, red, p.part + (size_t)blockIdx.x * p.part_ld + n0, p.n_out - n0);
    col_sums(db, red, p.part2 + (size_t)blockIdx.x * p.part_ld + n0, p.n_out - n0);
  } else {
    // START, DSKIP, CONVT, DX0, DXC, XC: one value a column
    float v[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; r += 2) {
      const int t = row_of(r), n = n0 + col_of(r);
      v[r] = v[r + 1] = 0.f;
      if (t >= p.T || n >= p.n_out) continue;
      const bool two = n + 1 < p.n_out;
      const size_t row = base + t;
      const float valid = t < len ? 1.0f : 0.0f;
      float x0 = sum[r], x1 = two ? sum[r + 1] : 0.0f;
      if constexpr (EPI == START) {
        x0 = (x0 + f32(p.bias[n])) * valid;
        x1 = two ? (x1 + f32(p.bias[n + 1])) * valid : 0.0f;
        st2(p.f0 + row * H + n, x0, x1, two);
      } else if constexpr (EPI == CONVT) {
        x0 = (p.last ? x0 : pre[r] + x0) * valid;
        x1 = (p.last ? x1 : pre[r + 1] + x1) * valid;
        st2(p.f0 + row * H + n, x0, x1, two);
      } else if constexpr (EPI == DXC) {
        x0 = (pre[r] + x0) * valid;
        x1 = (pre[r + 1] + x1) * valid;
      } else if constexpr (EPI != XC) {
        x0 *= valid;  // DSKIP, DX0
        x1 *= valid;
      }
      v[r] = x0;
      v[r + 1] = x1;
      st2(p.o0 + row * p.ld0 + n, x0, x1, two);
    }
    if constexpr (EPI == DSKIP || EPI == CONVT)
      col_sums(v, red, p.part + (size_t)blockIdx.x * p.part_ld + n0, p.n_out - n0);
  }
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

template <int EPI>
cudaError_t gemm(const Gemm& p, cudaStream_t s) {
  constexpr int smem = GemmSmem::BYTES;
  const cudaError_t err = allow_smem<wn16_gemm_kernel<EPI>>(smem);
  if (err != cudaSuccess) return err;
  const int cols = EPI == GATE ? gate_rows(p.H) : p.n_out;
  wn16_gemm_kernel<EPI><<<dim3(p.B * p.ntt, cdiv(cols, BN)), THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// ---- the weight gradients ------------------------------------------------------
// out[m sm + n sn] = sum over the frames t of X[t + shift, m] Y[t, n], m < M,
// n < N, X and Y [layers * B, T, C] bf16 maps (planes xplane + b, yplane + b)
constexpr int W_MAPS = 10;
enum WMap : int { M_X0, M_G, M_H, M_ACTS, M_SKIP, M_DSKIP, M_DH, M_DXIN, M_X1, M_DXC };
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

struct WParams {
  CUtensorMap maps[W_MAPS];
  WProb prob[MAX_PROBS];
  float* part;
  int n_probs, n_split, ntt, slabs;
};

__device__ __forceinline__ int prob_of(const WParams& p, int block) {
  int i = 0;
  while (i + 1 < p.n_probs && block >= p.prob[i + 1].block0) ++i;
  return i;
}

// one 64 x 128 job of a problem over its share of the slabs (64 frames of a
// sequence), split = block % n_split; its fp32 sums to the partials in the
// accumulators' order
__global__ void __launch_bounds__(THREADS) wn16_wsum_kernel(const __grid_constant__ WParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + W_BAR_OFF);
  const WProb& P = p.prob[prob_of(p, blockIdx.x)];
  const int local = blockIdx.x - P.block0, split = local % p.n_split, job = local / p.n_split;
  const int mi = job % P.mchunks, ni = job / P.mchunks;
  const int chunk = cdiv(p.slabs, p.n_split), s0 = split * chunk;
  const int n = max(0, min(p.slabs, s0 + chunk) - s0);
  const bool lead = threadIdx.x == 0;
  if (lead) {
    for (int i = 0; i < RING; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto load = [&](int k) {
    if (k >= n) return;
    const int s = s0 + k, b = s / p.ntt, t0 = (s % p.ntt) * TM;
    uint64_t* const f = &full[k % RING];
    uint8_t* const st = sm + (k % RING) * W_SLOT;
    mbar_expect_tx(f, W_SLOT);
    tma_load_3d(st, &p.maps[P.xmap], f, KC * mi, t0 + P.shift, P.xplane + b);
    tma_load_3d(st + W_CHUNK, &p.maps[P.ymap], f, 128 * ni, t0, P.yplane + b);
    tma_load_3d(st + 2 * W_CHUNK, &p.maps[P.ymap], f, 128 * ni + KC, t0, P.yplane + b);
  };
  if (lead)
    for (int k = 0; k < RING; ++k) load(k);
  float acc[64], sum[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = sum[r] = 0.f;
  for (int k = 0; k < n; ++k) {
    mbar_wait(&full[k % RING], (uint32_t)(k / RING) & 1u);
    const uint32_t xa = smem_u32(sm + (k % RING) * W_SLOT), yb = xa + W_CHUNK;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk)
      mma_k16<128, 1, 1>(acc, desc_b128(xa + 2048 * kk, W_CHUNK, 1024), desc_b128(yb + 2048 * kk, W_CHUNK, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lead) load(k + RING);
    if ((k + 1) % FLUSH == 0 || k + 1 == n) {
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        sum[r] += acc[r];
        acc[r] = 0.f;
      }
    }
  }
  if (p.n_split == 1) {  // the whole sum: straight into the gradient, in its layout and dtype
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < 64; ++r) {  // register r: row 16 warp + lane / 4 + 8 ((r / 2) % 2), column 8 (r / 4) + ...
      const int M = KC * mi + 16 * warp + (lane >> 2) + 8 * ((r >> 1) & 1);
      const int N = 128 * ni + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      if (M >= P.M || N >= P.N) continue;
      const size_t o = (size_t)M * P.sm + (size_t)N * P.sn;
      if (P.f32)
        static_cast<float*>(P.out)[o] = sum[r];
      else
        static_cast<bf16_t*>(P.out)[o] = __float2bfloat16_rn(sum[r]);
    }
    return;
  }
  float2* const part = reinterpret_cast<float2*>(p.part) + (size_t)blockIdx.x * (JOB_FLOATS / 2) + threadIdx.x;
#pragma unroll
  for (int pr = 0; pr < 32; ++pr) part[pr * 128] = make_float2(sum[2 * pr], sum[2 * pr + 1]);
}

// each job's shares added in a fixed order (read as they lie, into shared
// memory), then written once in the gradient's layout and dtype, the
// output's smaller stride varying fastest across the threads
__global__ void __launch_bounds__(256) wn16_wsum_reduce_kernel(const __grid_constant__ WParams p) {
  __shared__ float acc[JOB_FLOATS];
  const int jg = blockIdx.x;
  int i = 0;
  while (i + 1 < p.n_probs && jg >= p.prob[i + 1].block0 / p.n_split) ++i;
  const WProb& P = p.prob[i];
  const int job = jg - P.block0 / p.n_split, mi = job % P.mchunks, ni = job / P.mchunks;
  const float* src = p.part + (size_t)(P.block0 + job * p.n_split) * JOB_FLOATS;
#pragma unroll 8
  for (int e = threadIdx.x; e < JOB_FLOATS; e += 256) {
    float s = 0.f;
    for (int k = 0; k < p.n_split; ++k) s += src[(size_t)k * JOB_FLOATS + e];
    acc[e] = s;
  }
  __syncthreads();
  const bool m_fast = P.sm <= P.sn;
  for (int e = threadIdx.x; e < JOB_FLOATS; e += 256) {
    const int m = m_fast ? e & 63 : e >> 7, n = m_fast ? e >> 6 : e & 127;
    const int M = KC * mi + m, N = 128 * ni + n;
    if (M >= P.M || N >= P.N) continue;
    // where the accumulators keep (m, n): thread (m / 16) * 32 + (m % 8) * 4 + (n % 8) / 2, register
    // 4 (n / 8) + 2 ((m % 16) / 8) + n % 2
    const int th = (m >> 4) * 32 + (m & 7) * 4 + ((n & 7) >> 1);
    const int pr = 2 * (n >> 3) + ((m >> 3) & 1);
    const float v = acc[(pr * 128 + th) * 2 + (n & 1)];
    const size_t o = (size_t)M * P.sm + (size_t)N * P.sn;
    if (P.f32)
      static_cast<float*>(P.out)[o] = v;
    else
      static_cast<bf16_t*>(P.out)[o] = __float2bfloat16_rn(v);
  }
}

// ---- the bias gradients ----------------------------------------------------------
// part [S][R][Wp]: the column sums of the R tiles of source s: 0 dskip (H
// columns), 1 + i dh_i (H), 1 + L + i dx_in_i (2H), B6's 1 + 2L daln and
// 2 + 2L dalb (C); source S: g's rows themselves (dbend, every frame)
struct BiasParams {
  const float* part;
  const bf16_t* g;
  int S, R, Wp, H, L, c_out, g_rows, g_ld;
  bf16_t *dbs, *dbend;
  float *daln, *dalb;
  bf16_t* dbin[WN_STREAMS];
  bf16_t* dbrs[WN_STREAMS];
};

__global__ void __launch_bounds__(1024) wn16_bias_kernel(const __grid_constant__ BiasParams p) {
  __shared__ float s[32][33];
  const int cx = threadIdx.x & 31, r = threadIdx.x >> 5, c = blockIdx.x * 32 + cx, src = blockIdx.y;
  const int H = p.H, L = p.L;
  const int ncols = src == p.S ? p.c_out : src == 0 || src <= L ? H : src <= 2 * L ? 2 * H : p.c_out;
  float v = 0.f;
  if (c < ncols) {
    if (src == p.S) {
      for (int i = r; i < p.g_rows; i += 32) v += f32(p.g[(size_t)i * p.g_ld + c]);
    } else {
      const float* part = p.part + (size_t)src * p.R * p.Wp + c;
      for (int i = r; i < p.R; i += 32) v += part[(size_t)i * p.Wp];
    }
  }
  s[r][cx] = v;
  __syncthreads();
  if (r != 0 || c >= ncols) return;
  float t = 0.f;
  for (int k = 0; k < 32; ++k) t += s[k][cx];
  const bf16_t tb = __float2bfloat16_rn(t);
  if (src == p.S) {
    p.dbend[c] = tb;
  } else if (src == 0) {  // dskip: the skip half of every layer's drs, all of the last layer's
    for (int i = 0; i + 1 < L; ++i) p.dbrs[i][H + c] = tb;
    p.dbrs[L - 1][c] = tb;
  } else if (src <= L) {  // dh_i: dbs, or the residual half of layer i - 1's drs
    if (src == 1)
      p.dbs[c] = tb;
    else
      p.dbrs[src - 2][c] = tb;
  } else if (src <= 2 * L) {
    p.dbin[src - 1 - L][c] = tb;
  } else {
    (src == 2 * L + 1 ? p.daln : p.dalb)[c] = t;
  }
}

// ---- packing -------------------------------------------------------------------------
// dst[(j * rows + r) * pitch + c] for planes j, rows r, columns c: the
// source's element src[j s_plane + r' s_row + c s_col] (r' = r, or GATE's
// row order), zero where r' >= src_rows or c >= src_cols
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

__global__ void __launch_bounds__(256) wn16_pack_kernel(const __grid_constant__ PackParams p) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (int i = 0; i < p.n; ++i) {
    const PackJob& J = p.job[i];
    const unsigned total = (unsigned)J.planes * J.rows * J.cols;  // < 2^31 (pack)
    for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
      const int c = (int)(e % (unsigned)J.cols);
      const unsigned rj = e / (unsigned)J.cols;
      const int r = (int)(rj % (unsigned)J.rows), j = (int)(rj / (unsigned)J.rows);
      int sr = r;
      bool ok = c < J.src_cols;
      if (J.kind == P_GATE) {  // row group g: tanh channels 32 g .. 32 g + 31, then their sigmoid channels
        const int g = r / 64, w = r % 64, ch = 32 * g + (w & 31);
        sr = w < 32 ? ch : J.H + ch;
        ok = ok && ch < J.H;
      } else {
        ok = ok && r < J.src_rows;
      }
      float v = 0.f;
      if (ok) {
        const long long at = j * J.s_plane + sr * J.s_row + c * J.s_col;
        v = J.kind == P_F32 ? static_cast<const float*>(J.src)[at] : f32(static_cast<const bf16_t*>(J.src)[at]);
        if (J.kind == P_ACTNORM || J.kind == P_MASKED) {  // rows are the frames of [B, T]
          const bool valid = r % p.T < p.lens[r / p.T];
          v = J.kind == P_ACTNORM ? (p.alb[c] + expf(p.aln[c]) * v) * (valid ? 1.f : 0.f) : v * (valid ? 1.f : 0.f);
        }
      }
      J.dst[((long long)j * J.rows + r) * J.pitch + c] = __float2bfloat16_rn(v);
    }
  }
}

// ---- host ------------------------------------------------------------------------------
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

struct Shape {
  int B, T, half, H, c_out, L, k, rate;
};

bool valid_shape(const Shape& s) {
  return s.B >= 1 && s.T >= 1 && s.half >= 1 && s.H >= 1 && s.c_out >= 1 && s.L >= 1 && s.L <= WN_STREAMS &&
         (s.k == 1 || s.k == 3 || s.k == 5) && s.rate >= 1;
}

// The scratch, in ops/wn_coupling.py:BWD16_PARTS order (bf16 but for xin,
// h32, skip32, dh32 and the partials): every row pitch8 of its channels.
struct Bufs {
  bf16_t *x0, *g, *h, *acts, *skip, *dskip, *dh, *dxin;
  float *xin, *h32, *skip32, *dh32;
  bf16_t *w_s, *w_s_t, *w_end_t, *w_in, *w_in_t, *w_rs, *w_rs_t, *x1, *dxc, *mt_t, *mt;
  float *bias_part, *wsum_part;
};

Bufs bufs_of(void* const* b) {
  auto h = [&](int i) { return static_cast<bf16_t*>(b[i]); };
  auto f = [&](int i) { return static_cast<float*>(b[i]); };
  return Bufs{h(0),  h(1),  h(2),  h(3),  h(4),  h(5),  h(6),  h(7),  f(8),  f(9),  f(10), f(11), h(12),
              h(13), h(14), h(15), h(16), h(17), h(18), h(19), h(20), h(21), h(22), f(23), f(24)};
}

// a [planes, T, C] activation map in boxes of 64 channels x 64 frames
bool act_map(CUtensorMap* m, const bf16_t* base, int C, int T, int planes) {
  return bf16_map(m, base, C, T, planes, (uint64_t)pitch8(C) * 2, (uint64_t)T * pitch8(C) * 2, KC, TM);
}

// a [planes, N, K] weight map (K-major rows) in boxes of 64 columns x box_rows
bool w_map(CUtensorMap* m, const bf16_t* base, int K, int N, int planes, int box_rows) {
  return bf16_map(m, base, K, N, planes, (uint64_t)pitch8(K) * 2, (uint64_t)N * pitch8(K) * 2, KC, box_rows);
}

// The weight-gradient problems (pointers may be null when only the blocks are wanted).
struct Grads {
  bf16_t *dws, *dwend;
  bf16_t* const* dwin;
  bf16_t* const* dwrs;
  float* dmt;
};

std::vector<WProb> problems(const Shape& sh, const Grads& d, bool flow) {
  const int H = sh.H, L = sh.L, k = sh.k, C = sh.c_out;
  std::vector<WProb> v;
  auto add = [&](void* out, int f32, int xmap, int xplane, int shift, int M, int ymap, int yplane, int N, int sm,
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
    v.push_back(q);
  };
  auto at = [](bf16_t* p, size_t off) { return p ? (void*)(p + off) : nullptr; };
  add(d.dws, 0, M_X0, 0, 0, sh.half, M_DH, 0, H, 1, sh.half);  // dws[n, c] = sum dh_0[t, n] x0[t, c]
  int dil = 1;
  for (int i = 0; i < L; ++i, dil *= sh.rate) {
    const int pad = (k - 1) / 2 * dil;
    for (int j = 0; j < k; ++j)  // dwin[n, c, j] = sum dxin[t, n] h[t + j dil - pad, c]
      add(at(d.dwin ? d.dwin[i] : nullptr, j), 0, M_H, i * sh.B, j * dil - pad, H, M_DXIN, i * sh.B, 2 * H, k, H * k);
    bf16_t* dwrs = d.dwrs ? d.dwrs[i] : nullptr;  // dwrs[n, h] = sum drs[t, n] acts[t, h]
    if (i + 1 < L) add(dwrs, 0, M_ACTS, i * sh.B, 0, H, M_DH, (i + 1) * sh.B, H, 1, H);
    add(at(dwrs, i + 1 < L ? (size_t)H * H : 0), 0, M_ACTS, i * sh.B, 0, H, M_DSKIP, 0, H, 1, H);
  }
  add(d.dwend, 0, M_SKIP, 0, 0, H, M_G, 0, C, 1, H);  // dwend[n, h] = sum g[t, n] (skip valid)[t, h]
  if (flow) add(d.dmt, 1, M_X1, 0, 0, C, M_DXC, 0, C, C, 1);  // dmt[c, n] = sum x1[t, c] dxc[t, n]
  return v;
}

// the problems' launches (at most MAX_PROBS each) with their blocks assigned; the frame split
int assign(std::vector<WProb>& v, const Shape& sh, long long* most_blocks) {
  long long jobs = 0;
  for (const WProb& q : v) jobs += (long long)q.mchunks * q.ntiles;
  const int slabs = sh.B * cdiv(sh.T, TM);
  // about two resident blocks an SM; one share a job (no partials) where the jobs fill that
  const long long target = 2LL * (sm_count() > 0 ? sm_count() : 132);
  int n_split = (int)((target + jobs / 2) / jobs);
  n_split = n_split < 1 ? 1 : n_split > slabs ? slabs : n_split;
  *most_blocks = 0;
  for (size_t u0 = 0; u0 < v.size(); u0 += MAX_PROBS) {
    int block = 0;
    for (size_t i = u0; i < v.size() && i < u0 + MAX_PROBS; ++i) {
      v[i].block0 = block;
      block += v[i].mchunks * v[i].ntiles * n_split;
    }
    *most_blocks = block > *most_blocks ? block : *most_blocks;
  }
  return n_split;
}

cudaError_t weight_sums(std::vector<WProb> v, const Shape& sh, const CUtensorMap (&maps)[W_MAPS], float* part,
                        cudaStream_t s) {
  long long most;
  const int n_split = assign(v, sh, &most);
  WParams p{};
  for (int i = 0; i < W_MAPS; ++i) p.maps[i] = maps[i];
  p.part = part;
  p.n_split = n_split;
  p.ntt = cdiv(sh.T, TM);
  p.slabs = sh.B * p.ntt;
  cudaError_t err = allow_smem<wn16_wsum_kernel>(W_SMEM);
  for (size_t u0 = 0; u0 < v.size() && err == cudaSuccess; u0 += MAX_PROBS) {
    p.n_probs = (int)(v.size() - u0 < (size_t)MAX_PROBS ? v.size() - u0 : MAX_PROBS);
    for (int i = 0; i < p.n_probs; ++i) p.prob[i] = v[u0 + i];
    const WProb& last = p.prob[p.n_probs - 1];
    const int blocks = last.block0 + last.mchunks * last.ntiles * n_split;
    wn16_wsum_kernel<<<blocks, THREADS, W_SMEM, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) continue;
    wn16_wsum_reduce_kernel<<<blocks / n_split, 256, 0, s>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

// floats of the weight sums' partials (the largest launch's blocks x 64 x 128; none without a split)
long wsum_part_floats(const Shape& sh, bool flow) {
  std::vector<WProb> v = problems(sh, Grads{}, flow);
  long long most;
  return assign(v, sh, &most) > 1 ? (long)(most * JOB_FLOATS) : 0;
}

// Inputs of the conditioner's chain, after the prefix (B6) or the packing of x0 (B3).
struct Weights {
  const bf16_t* ws;
  const bf16_t* const* win;
  const bf16_t* const* wrs;
  const bf16_t* wend;
  const bf16_t* bs;
  const bf16_t* const* bin;
  const bf16_t* const* brs;
};

// columns of W_rs^T: the residual half's H, zeros to a 64-column boundary, the skip half's H
__host__ __device__ constexpr int rs_t_cols(int H) { return KC * cdiv(H, KC) + H; }

// the weights' packing jobs: W_s [H][half], W_s^T [half][H], W_end^T [H][c_out], W_in in the
// gate's row order [L k][gate_rows(H)][H], W_in transposed [L k][H][2H], W_rs [L][2H][H]
// (the last layer's H rows, then zeros), W_rs^T [L][H][rs_t_cols(H)] (the last layer's skip half zeros)
void weight_jobs(const Weights& w, const Shape& sh, const Bufs& u, std::vector<PackJob>& jobs) {
  const int H = sh.H, L = sh.L, k = sh.k, half = sh.half, C = sh.c_out;
  const int R2 = gate_rows(H), rst = rs_t_cols(H);
  auto job = [&](const void* src, bf16_t* dst, long long sp, long long sr, long long sc, int planes, int rows,
                 int cols, int src_rows, int src_cols, int kind, int pitch = 0) {
    PackJob J{};
    J.src = src;
    J.dst = dst;
    J.s_plane = sp;
    J.s_row = sr;
    J.s_col = sc;
    J.planes = planes;
    J.rows = rows;
    J.cols = cols;
    J.pitch = pitch ? pitch : pitch8(cols);
    J.src_rows = src_rows;
    J.src_cols = src_cols;
    J.kind = kind;
    J.H = H;
    jobs.push_back(J);
  };
  job(w.ws, u.w_s, 0, half, 1, 1, H, half, H, half, P_BF16);
  job(w.ws, u.w_s_t, 0, 1, half, 1, half, H, half, H, P_BF16);
  job(w.wend, u.w_end_t, 0, 1, H, 1, H, C, H, C, P_BF16);
  for (int i = 0; i < L; ++i) {
    const int rs = i + 1 < L ? 2 * H : H;
    job(w.win[i], u.w_in + (size_t)i * k * R2 * pitch8(H), 1, (long long)H * k, k, k, R2, H, 2 * H, H, P_GATE);
    job(w.win[i], u.w_in_t + (size_t)i * k * H * pitch8(2 * H), 1, k, (long long)H * k, k, H, 2 * H, H, 2 * H,
        P_BF16);
    job(w.wrs[i], u.w_rs + (size_t)i * 2 * H * pitch8(H), 0, H, 1, 1, 2 * H, H, rs, H, P_BF16);
    bf16_t* const rs_t = u.w_rs_t + (size_t)i * H * pitch8(rst);
    job(w.wrs[i], rs_t, 0, 1, H, 1, H, KC * cdiv(H, KC), H, H, P_BF16, pitch8(rst));
    job(static_cast<const bf16_t*>(w.wrs[i]) + (size_t)H * H, rs_t + KC * cdiv(H, KC), 0, 1, H, 1, H, H, H,
        i + 1 < L ? H : 0, P_BF16, pitch8(rst));
  }
}

cudaError_t pack(std::vector<PackJob>& jobs, const int* lens, int T, const float* aln, const float* alb,
                 cudaStream_t s) {
  PackParams p{};
  p.T = T;
  p.lens = lens;
  p.aln = aln;
  p.alb = alb;
  const int grid = 4 * (sm_count() > 0 ? sm_count() : 132);
  for (const PackJob& J : jobs)
    if ((long long)J.planes * J.rows * J.cols >= (1LL << 31)) return cudaErrorInvalidValue;
  for (size_t u0 = 0; u0 < jobs.size(); u0 += MAX_JOBS) {
    p.n = (int)(jobs.size() - u0 < (size_t)MAX_JOBS ? jobs.size() - u0 : MAX_JOBS);
    for (int i = 0; i < p.n; ++i) p.job[i] = jobs[u0 + i];
    wn16_pack_kernel<<<grid, 256, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

struct Maps {
  CUtensorMap act[W_MAPS];
  CUtensorMap w_s, w_s_t, w_end_t, w_in, w_in_t, w_rs, w_rs_t, mt_t, mt;
};

bool encode_maps(const Shape& sh, const Bufs& u, bool flow, Maps* m) {
  const int B = sh.B, T = sh.T, H = sh.H, L = sh.L, k = sh.k, C = sh.c_out, half = sh.half;
  bool ok = act_map(&m->act[M_X0], u.x0, half, T, B) && act_map(&m->act[M_G], u.g, C, T, B) &&
            act_map(&m->act[M_H], u.h, H, T, L * B) && act_map(&m->act[M_ACTS], u.acts, H, T, L * B) &&
            act_map(&m->act[M_SKIP], u.skip, H, T, B) && act_map(&m->act[M_DSKIP], u.dskip, H, T, B) &&
            act_map(&m->act[M_DH], u.dh, H, T, L * B) && act_map(&m->act[M_DXIN], u.dxin, 2 * H, T, L * B);
  ok = ok && w_map(&m->w_s, u.w_s, half, H, 1, 64) && w_map(&m->w_s_t, u.w_s_t, H, half, 1, 64) &&
       w_map(&m->w_end_t, u.w_end_t, C, H, 1, 64) && w_map(&m->w_in, u.w_in, H, gate_rows(H), L * k, 64) &&
       w_map(&m->w_in_t, u.w_in_t, 2 * H, H, L * k, 64) && w_map(&m->w_rs, u.w_rs, H, 2 * H, L, 64) &&
       w_map(&m->w_rs_t, u.w_rs_t, rs_t_cols(H), H, L, 64);
  if (flow)
    ok = ok && act_map(&m->act[M_X1], u.x1, C, T, B) && act_map(&m->act[M_DXC], u.dxc, C, T, B) &&
         w_map(&m->mt_t, u.mt_t, C, half, 1, 64) && w_map(&m->mt, u.mt, C, C, 1, 64);
  else
    m->act[M_X1] = m->act[M_DXC] = m->act[M_X0];  // unused
  return ok;
}

// The maps of a call, from a cache of the last few calls' (the caching
// allocator hands a wrapper the same scratch call after call, and encoding
// the maps is a large part of a call's host time). A key holds every
// pointer and size a map reads. Host calls come from one thread.
bool make_maps(const Shape& sh, const Bufs& u, bool flow, Maps* m) {
  struct Key {
    Bufs u;
    Shape sh;
    int flow;
  };
  struct Entry {
    Key key;
    Maps maps;
  };
  static std::vector<Entry> cache;
  static size_t next = 0;
  Key key;
  memset(&key, 0, sizeof(key));  // padding included: keys compare as bytes
  key.u = u;
  key.sh = sh;
  key.flow = flow;
  for (const Entry& e : cache)
    if (memcmp(&e.key, &key, sizeof(Key)) == 0) {
      *m = e.maps;
      return true;
    }
  if (!encode_maps(sh, u, flow, m)) return false;
  constexpr size_t SLOTS = 8;
  if (cache.size() < SLOTS) {
    cache.push_back(Entry{key, *m});
  } else {
    cache[next] = Entry{key, *m};
    next = (next + 1) % SLOTS;
  }
  return true;
}

// A product over one source (or two) and its epilogue's common fields.
Gemm product(const Shape& sh, const CUtensorMap& a0, int plane0, int c_a0, const CUtensorMap& w, int w_plane, int taps,
             int dil, int sign, int n_out, const int* lens) {
  Gemm p{};
  p.a[0] = p.a[1] = a0;
  p.a_plane[0] = p.a_plane[1] = plane0;
  p.ch0 = cdiv(c_a0, KC);
  p.w = w;
  p.w_plane = w_plane;
  p.taps = taps;
  p.dil = dil;
  p.sign = sign;
  p.B = sh.B;
  p.T = sh.T;
  p.ntt = cdiv(sh.T, TM);
  p.H = sh.H;
  p.n_out = n_out;
  p.lens = lens;
  return p;
}

// The conditioner's chain from the packed x0 and g: the recompute, dskip,
// the layers' transposed products in reverse, then (B3) dx0 into dx0 or
// (B6) dxc's first half (g_xc + dh_0 W_s) * valid into the scratch.
cudaError_t chain(const Shape& sh, const Weights& w, const Bufs& u, const Maps& m, const int* lens,
                  const long long* seed, unsigned threshold, float keep_scale, const bf16_t* g_xc, bf16_t* dx0,
                  cudaStream_t s) {
  const int B = sh.B, T = sh.T, H = sh.H, L = sh.L, k = sh.k, half = sh.half;
  const size_t lay = (size_t)B * T, ph = pitch8(H), p2h = pitch8(2 * H);
  const int R = B * cdiv(T, TM), Wp = 2 * H > sh.c_out ? 2 * H : sh.c_out;
  auto part = [&](int src) { return u.bias_part + (size_t)src * R * Wp; };

  Gemm p = product(sh, m.act[M_X0], 0, half, m.w_s, 0, 1, 1, 1, H, lens);  // h_0
  p.bias = w.bs;
  p.f0 = u.h32;
  p.o0 = u.h;
  p.ld0 = (int)ph;
  cudaError_t err = gemm<START>(p, s);
  int dil = 1;
  for (int i = 0; i < L && err == cudaSuccess; ++i, dil *= sh.rate) {
    p = product(sh, m.act[M_H], i * B, H, m.w_in, i * k, k, dil, 1, 2 * H, lens);  // x_in_i, acts_i
    p.seed = seed;
    p.threshold = threshold;
    p.keep_scale = keep_scale;
    p.layer = i;
    p.bias = w.bin[i];
    p.f0 = u.xin + i * lay * 2 * H;
    p.o0 = u.acts + i * lay * ph;
    p.ld0 = (int)ph;
    err = gemm<GATE>(p, s);
    if (err != cudaSuccess) break;
    const bool last = i + 1 == L;  // h_{i+1}, the skip sum
    p = product(sh, m.act[M_ACTS], i * B, H, m.w_rs, i, 1, 1, 1, last ? H : 2 * H, lens);
    p.bias = w.brs[i];
    p.first = i == 0;
    p.last = last;
    p.f0 = u.h32;
    p.f1 = u.skip32;
    p.o0 = last ? nullptr : u.h + (i + 1) * lay * ph;
    p.o1 = u.skip;
    p.ld0 = p.ld1 = (int)ph;
    err = gemm<RES>(p, s);
  }
  if (err != cudaSuccess) return err;

  p = product(sh, m.act[M_G], 0, sh.c_out, m.w_end_t, 0, 1, 1, 1, H, lens);  // dskip
  p.o0 = u.dskip;
  p.ld0 = (int)ph;
  p.part = part(0);
  p.part_ld = Wp;
  err = gemm<DSKIP>(p, s);
  for (int i = L - 1; i >= 0 && err == cudaSuccess; --i) {
    dil = 1;
    for (int j = 0; j < i; ++j) dil *= sh.rate;
    const bool last = i + 1 == L;
    // dx_in_i from dacts = drs W_rs_i, drs = [dh_{i+1}, dskip] (dskip alone for the last layer)
    p = last ? product(sh, m.act[M_DSKIP], 0, H, m.w_rs_t, i, 1, 1, 1, H, lens)
             : product(sh, m.act[M_DH], (i + 1) * B, H, m.w_rs_t, i, 1, 1, 1, H, lens);
    if (!last) {
      p.a[1] = m.act[M_DSKIP];
      p.a_plane[1] = 0;
      p.ch1 = cdiv(H, KC);
    }
    p.seed = seed;
    p.threshold = threshold;
    p.keep_scale = keep_scale;
    p.layer = i;
    p.f0 = u.xin + i * lay * 2 * H;
    p.o0 = u.dxin + i * lay * p2h;
    p.ld0 = (int)p2h;
    p.part = part(1 + L + i);
    p.part_ld = Wp;
    err = gemm<GATE_BWD>(p, s);
    if (err != cudaSuccess) break;
    // dh_i = (dh_{i+1} + conv_k^T(dx_in_i, W_in_i)) * valid
    p = product(sh, m.act[M_DXIN], i * B, 2 * H, m.w_in_t, i * k, k, dil, -1, H, lens);
    p.last = last;
    p.f0 = u.dh32;
    p.o0 = u.dh + i * lay * ph;
    p.ld0 = (int)ph;
    p.part = part(1 + i);
    p.part_ld = Wp;
    err = gemm<CONVT>(p, s);
  }
  if (err != cudaSuccess) return err;
  p = product(sh, m.act[M_DH], 0, H, m.w_s_t, 0, 1, 1, 1, half, lens);
  if (g_xc) {  // B6: dxc's first half
    p.r16 = g_xc;
    p.ldr = sh.c_out;
    p.o0 = u.dxc;
    p.ld0 = pitch8(sh.c_out);
    return gemm<DXC>(p, s);
  }
  p.o0 = dx0;
  p.ld0 = half;
  return gemm<DX0>(p, s);
}

BiasParams bias_params(const Shape& sh, const Bufs& u, bf16_t* dbs, bf16_t* const* dbin, bf16_t* const* dbrs,
                       bf16_t* dbend, float* daln, float* dalb) {
  BiasParams b{};
  b.part = u.bias_part;
  b.g = u.g;
  b.L = sh.L;
  b.H = sh.H;
  b.S = 1 + 2 * sh.L + (daln ? 2 : 0);
  b.R = sh.B * cdiv(sh.T, TM);
  b.Wp = 2 * sh.H > sh.c_out ? 2 * sh.H : sh.c_out;
  b.c_out = sh.c_out;
  b.g_rows = sh.B * sh.T;
  b.g_ld = pitch8(sh.c_out);
  b.dbs = dbs;
  b.dbend = dbend;
  b.daln = daln;
  b.dalb = dalb;
  for (int i = 0; i < sh.L; ++i) {
    b.dbin[i] = dbin[i];
    b.dbrs[i] = dbrs[i];
  }
  return b;
}

cudaError_t biases(const BiasParams& b, cudaStream_t s) {
  const int cols = b.Wp > b.c_out ? b.Wp : b.c_out;
  wn16_bias_kernel<<<dim3(cdiv(cols, 32), b.S + 1), 1024, 0, s>>>(b);
  return cudaGetLastError();
}

}  // namespace wn16

using wn16::bf16_t;

// Floats of the weight sums' partials that wn_coupling_bwd_bf16 (flow 0)
// and flow_step_bwd_bf16 (flow 1) need in the scratch (-1 for a shape the
// kernels do not take); the rest of the scratch is ops/wn_coupling.py's
// bwd16_layout.
extern "C" long wn16_wsum_part_floats(int B, int T, int half, int H, int c_out, int n_layers, int kernel_size,
                                      int dilation_rate, int flow) {
  const wn16::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn16::valid_shape(sh) || (flow && c_out != 2 * half) || wn16::sm_count() < 1) return -1;
  return wn16::wsum_part_floats(sh, flow != 0);
}

// B3's bf16 backward on `stream`; returns a cudaError_t (0 on success).
// x0 [B, T, half] bf16 with rows ldx elements apart (any offset), g [B, T,
// c_out] and the weights contiguous bf16 in PyTorch's layouts; dx0 [B, T,
// half] contiguous and every gradient bf16; `scratch` the pointers of
// ops/wn_coupling.py:bwd16_layout's parts, BWD16_PARTS order (B6's null).
extern "C" int wn_coupling_bwd_bf16(const void* x0, int ldx, const int* lens, const long long* seed, const void* g,
                                    const void* ws, const void* const* win, const void* const* wrs, const void* wend,
                                    const void* bs, const void* const* bin, const void* const* brs, void* dx0,
                                    void* dws, void* dbs, void* const* dwin, void* const* dbin, void* const* dwrs,
                                    void* const* dbrs, void* dwend, void* dbend, void* const* scratch, int B, int T,
                                    int half, int H, int c_out, int n_layers, int kernel_size, int dilation_rate,
                                    unsigned threshold, float keep_scale, void* stream) {
  using namespace wn16;
  const Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!valid_shape(sh) || sm_count() < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bufs u = bufs_of(scratch);
  using C = const bf16_t*;
  using CP = const bf16_t* const*;
  using P = bf16_t*;
  using PP = bf16_t* const*;
  const Weights w{C(ws), CP(win), CP(wrs), C(wend), C(bs), CP(bin), CP(brs)};
  Maps m;
  if (!make_maps(sh, u, false, &m)) return (int)cudaErrorInvalidValue;
  std::vector<PackJob> jobs;
  weight_jobs(w, sh, u, jobs);
  PackJob a{};  // x0 and g into their padded buffers
  a.src = x0;
  a.dst = u.x0;
  a.s_row = ldx;
  a.s_col = 1;
  a.planes = 1;
  a.rows = a.src_rows = B * T;
  a.cols = a.src_cols = half;
  a.pitch = pitch8(half);
  a.kind = P_BF16;
  jobs.push_back(a);
  a.src = g;
  a.dst = u.g;
  a.s_row = c_out;
  a.cols = a.src_cols = c_out;
  a.pitch = pitch8(c_out);
  jobs.push_back(a);
  cudaError_t err = pack(jobs, lens, T, nullptr, nullptr, s);
  if (err == cudaSuccess) err = chain(sh, w, u, m, lens, seed, threshold, keep_scale, nullptr, P(dx0), s);
  if (err == cudaSuccess)
    err = weight_sums(problems(sh, Grads{P(dws), P(dwend), PP(dwin), PP(dwrs), nullptr}, false), sh, m.act,
                      u.wsum_part, s);
  if (err == cudaSuccess)
    err = biases(bias_params(sh, u, P(dbs), PP(dbin), PP(dbrs), P(dbend), nullptr, nullptr), s);
  return (int)err;
}

// B6's bf16 backward on `stream`; returns a cudaError_t. x, g_xc, g_out
// [B, T, C] contiguous bf16 (C = 2 half = c_out); aln, alb [C] and mt [C, C]
// fp32; the conditioner's weights bf16; dx [B, T, C] and the conditioner's
// gradients bf16, daln, dalb, dmt fp32; `scratch` as wn_coupling_bwd_bf16's.
extern "C" int flow_step_bwd_bf16(const void* x, const int* lens, const long long* seed, const void* g_xc,
                                  const void* g_out, const float* aln, const float* alb, const float* mt,
                                  const void* ws, const void* const* win, const void* const* wrs, const void* wend,
                                  const void* bs, const void* const* bin, const void* const* brs, void* dx,
                                  float* daln, float* dalb, float* dmt, void* dws, void* dbs, void* const* dwin,
                                  void* const* dbin, void* const* dwrs, void* const* dbrs, void* dwend, void* dbend,
                                  void* const* scratch, int B, int T, int half, int H, int c_out, int n_layers,
                                  int kernel_size, int dilation_rate, unsigned threshold, float keep_scale,
                                  void* stream) {
  using namespace wn16;
  const Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!valid_shape(sh) || c_out != 2 * half || sm_count() < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bufs u = bufs_of(scratch);
  using C = const bf16_t*;
  using CP = const bf16_t* const*;
  using P = bf16_t*;
  using PP = bf16_t* const*;
  const int Cc = c_out;
  const Weights w{C(ws), CP(win), CP(wrs), C(wend), C(bs), CP(bin), CP(brs)};
  Maps m;
  if (!make_maps(sh, u, true, &m)) return (int)cudaErrorInvalidValue;
  std::vector<PackJob> jobs;
  weight_jobs(w, sh, u, jobs);
  PackJob a{};
  a.planes = 1;
  a.s_col = 1;
  a.rows = a.src_rows = B * T;
  a.src = g_out;  // g
  a.dst = u.g;
  a.s_row = Cc;
  a.cols = a.src_cols = Cc;
  a.pitch = pitch8(Cc);
  a.kind = P_BF16;
  jobs.push_back(a);
  a.src = x;  // x1 = (alb + exp(aln) x) * valid
  a.dst = u.x1;
  a.kind = P_ACTNORM;
  jobs.push_back(a);
  a.src = C(g_xc) + half;  // dxc's second half: g_xc[:, half:] * valid
  a.dst = u.dxc + half;
  a.cols = a.src_cols = Cc - half;
  a.kind = P_MASKED;
  jobs.push_back(a);
  a = PackJob{};  // mt^T's first half rows [half][C] and mt [C][C], fp32 to bf16
  a.src = mt;
  a.dst = u.mt_t;
  a.planes = 1;
  a.rows = a.src_rows = half;
  a.cols = a.src_cols = Cc;
  a.pitch = pitch8(Cc);
  a.s_row = 1;
  a.s_col = Cc;
  a.kind = P_F32;
  jobs.push_back(a);
  a.dst = u.mt;
  a.rows = a.src_rows = Cc;
  a.s_row = Cc;
  a.s_col = 1;
  jobs.push_back(a);
  cudaError_t err = pack(jobs, lens, T, aln, alb, s);
  if (err != cudaSuccess) return (int)err;
  Gemm p = product(sh, m.act[M_X1], 0, Cc, m.mt_t, 0, 1, 1, 1, half, lens);  // x0 = (x1 mt)[:, :half]
  p.o0 = u.x0;
  p.ld0 = pitch8(half);
  err = gemm<XC>(p, s);
  if (err == cudaSuccess) err = chain(sh, w, u, m, lens, seed, threshold, keep_scale, C(g_xc), nullptr, s);
  if (err != cudaSuccess) return (int)err;
  const int R = B * cdiv(T, TM), Wp = 2 * H > Cc ? 2 * H : Cc;
  p = product(sh, m.act[M_DXC], 0, Cc, m.mt, 0, 1, 1, 1, Cc, lens);  // dx1 = dxc mt^T; dx; daln, dalb
  p.r16 = C(x);
  p.ldr = Cc;
  p.aln = aln;
  p.o0 = P(dx);
  p.ld0 = Cc;
  p.part = u.bias_part + (size_t)(1 + 2 * n_layers) * R * Wp;
  p.part2 = u.bias_part + (size_t)(2 + 2 * n_layers) * R * Wp;
  p.part_ld = Wp;
  err = gemm<DX1>(p, s);
  if (err == cudaSuccess)
    err = weight_sums(problems(sh, Grads{P(dws), P(dwend), PP(dwin), PP(dwrs), dmt}, true), sh, m.act,
                      u.wsum_part, s);
  if (err == cudaSuccess) err = biases(bias_params(sh, u, P(dbs), PP(dbin), PP(dbrs), P(dbend), daln, dalb), s);
  return (int)err;
}
