// The Glow-TTS coupling conditioner in bf16 for Hopper (sm_90a), forward
// and recompute backward, on one engine for B3 (wn_coupling_fwd_bf16,
// wn_coupling_bwd_bf16) and the whole flow step, B6 (flow_step_fwd_bf16,
// flow_step_bwd_bf16): every product on wgmma with both operands bf16,
// staged by TMA into mbarrier rings (hopper.cuh), fp32 sums. The forward is
// the backward's recompute, launch for launch (recompute below), so the
// backward's x_in, acts, h and skip sum are the forward's bits, as the TPU
// kernel's forward and backward share one _forward_body. The fp32 modes
// stay in wn_coupling_{fwd,bwd}.cu and flow_step_{fwd,bwd}.cu.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, functions
// fused_wn_coupling -> _fwd -> pallas_call(_fwd_kernel) (body _forward_body),
// _vjp_bwd -> _bwd -> pallas_call(_bwd_kernel) (body _conditioner_bwd),
// fused_flow_step -> _fwd_flow -> pallas_call(_fwd_flow_kernel) and
// _flow_vjp_bwd -> _bwd_flow -> pallas_call(_bwd_flow_kernel), in their bf16
// mode (dot_dtype bf16). Plain versions: ops/wn_coupling.py:
// wn_coupling_reference, wn_coupling_backward_reference, ops/flow_step.py:
// flow_step_reference, flow_step_backward_reference. Rounding points, as
// the TPU kernel's: every product's operands bf16 (_dot), fp32 sums; the
// gate, its derivative, the residual chains of h and dh, the skip sum and
// the ActNorm fp32; out, xc (B6), dx0 (B3) and dx (B6) written in bf16; the
// conditioner's weight gradients fp32 sums over every frame cast to bf16
// once, dmt, daln and dalb fp32.
//
// The forward: B6 first x1 = (alb + exp(aln) x) * valid, xc = x1 mt (all C
// columns, bf16), x0 = xc[:, :half]; then the recompute below, and out =
// (skip * valid) W_end + b_end with b_end at every frame, padded ones
// included (wn_coupling.py:178).
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
// k 5, 4 layers, c_out 160) the forward costs about 3.56 MFLOP a frame,
// 10.9 GFLOP at (8, 384): 0.011 ms at 989 TFLOP/s of bf16 (B6 0.05 MFLOP a
// frame more for xc); the backward about 7.9 MFLOP a frame (the recompute, the
// transposed products and the weight products, 3x the forward), 24 GFLOP:
// 0.024 ms; the inputs and outputs move about 0.5 KB (forward) and 1 KB
// (backward) a frame.
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
// past the lengths. The weight gradients are wn16_wsum_kernel (the engine
// this file shares with B5's bf16 backward: bf16_engine.cuh): a block
// computes 64 x 128 outputs of one problem over the frames (the frames as
// wgmma's K, both operands MN-major as they lie in device memory, fp32 sums
// every FLUSH slabs) and writes them in the gradient's own layout and
// dtype; where the jobs are too few to fill the card, over a fixed share of
// the frames, and wn16_wsum_reduce_kernel adds the shares in a fixed order.
// The engine's column sums (wn16_bias_kernel) add the bias partials. No
// float atomics: two calls are bitwise equal. Launches a call at Glow's
// shape (4 layers): B3's backward 22 (a pack, 1 + 2 L recompute products,
// 1 + 2 L transposed, dx0, the weight sums, the biases), B6's 24 (x1 mt and
// dx1 = dxc mt^T more).
//
// The forward runs the backward's pack (only the weights it reads, and x0,
// or B6's x1 and mt^T), B6's x1 mt over all C columns into the caller's xc,
// the same recompute launches and an END product into the caller's out:
// B3 11 launches (pack, 1 + 2 L, END), B6 12. Its scratch
// (ops/wn_coupling.py:fwd16_layout, one allocation) keeps h in two planes
// and acts in one (no weight sum reads them); x_in goes to device memory
// only when the caller asks for it (the wrapper's return_buffers). B6's
// conditioner reads x0 in place from xc through a map of width half and
// row pitch C where the pitch is a multiple of 16 bytes, else from a
// padded copy that XC writes beside xc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <string.h>

#include <vector>

#include "bf16_engine.cuh"
#include "hash.cuh"

namespace wn16 {

constexpr int WN_STREAMS = 64;  // ops/wn_coupling.py WN_STREAMS: hash streams a sequence, one a layer

// ---- the products ------------------------------------------------------------
enum Epi : int { START, GATE, RES, DSKIP, GATE_BWD, CONVT, DX0, DXC, XC, DX1, END };

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
  float* f0;  // fp32 state: h (START, RES), x_in (GATE, not stored where null; GATE_BWD), dh (CONVT)
  float* f1;  // RES: the skip sum
  bf16_t* o0;  // the bf16 output (rows ld0 apart)
  bf16_t* o1;  // RES of the last layer: skip * valid; XC: where set, a copy of columns < n1 (x0)
  int ld0, ld1, n1;
  const bf16_t* r16;  // DXC: g_xc, DX1: x (rows ldr apart)
  int ldr;
  const float* aln;   // DX1
  float* part;        // column sums' partials: row = the tile's, part_ld floats a row
  float* part2;
  int part_ld;
};

// rows of W_in's conv form: per 32 channels, their tanh rows then their sigmoid rows
__host__ __device__ constexpr int gate_rows(int H) { return 2 * 32 * cdiv(H, 32); }

__device__ __forceinline__ float drop(const Gemm& p, uint32_t key, int t, int c) {
  if (!p.threshold) return 1.0f;
  return hash_draw(key, (uint32_t)t * (uint32_t)(2 * p.H) + (uint32_t)c) >= p.threshold ? p.keep_scale : 0.0f;
}

template <int EPI>
__global__ void __launch_bounds__(THREADS) wn16_gemm_kernel(const __grid_constant__ Gemm p) {
  using S = GemmSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + S::BAR_OFF);
  float* const red = reinterpret_cast<float*>(sm + S::RED_OFF);
  const int b = blockIdx.x / p.ntt, t0 = (blockIdx.x % p.ntt) * TM, n0 = blockIdx.y * BN;
  const int ns = p.taps * (p.ch0 + p.ch1);
  const bool lead = threadIdx.x == 0;
  ring_init(full);
  auto load = [&](int s) {
    if (s < ns) load_slice(p, sm, full, s, s, b, t0, n0);
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

  float sum[BN / 2];
  ring_products(sm, full, ns, load, sum);

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
      if (p.f0) {
        st2(p.f0 + row * 2 * H + c, zt[0], zt[1], two);
        st2(p.f0 + row * 2 * H + H + c, zg[0], zg[1], two);
      }
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
    // START, DSKIP, CONVT, DX0, DXC, XC, END: one value a column
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
      } else if constexpr (EPI == END) {  // the bias at every frame, padded ones included
        x0 += f32(p.bias[n]);
        x1 = two ? x1 + f32(p.bias[n + 1]) : 0.0f;
      } else if constexpr (EPI != XC) {
        x0 *= valid;  // DSKIP, DX0
        x1 *= valid;
      }
      v[r] = x0;
      v[r + 1] = x1;
      st2(p.o0 + row * p.ld0 + n, x0, x1, two);
      if constexpr (EPI == XC)
        if (p.o1 && n < p.n1) st2(p.o1 + row * p.ld1 + n, x0, x1, n + 1 < p.n1);
    }
    if constexpr (EPI == DSKIP || EPI == CONVT)
      col_sums(v, red, p.part + (size_t)blockIdx.x * p.part_ld + n0, p.n_out - n0);
  }
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

// ---- the weight gradients (bf16_engine.cu's weight sums) ------------------------------
enum WMap : int { M_X0, M_G, M_H, M_ACTS, M_SKIP, M_DSKIP, M_DH, M_DXIN, M_X1, M_DXC };

// ---- host ------------------------------------------------------------------------------
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
                 int sn) { v.push_back(wprob(out, f32, xmap, xplane, shift, M, ymap, yplane, N, sm, sn)); };
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

// floats of the weight sums' partials (the largest launch's blocks x 64 x 128; none without a split)
long wsum_part_floats(const Shape& sh, bool flow) {
  std::vector<WProb> v = problems(sh, Grads{}, flow);
  long long most;
  return assign(v, sh.B, sh.T, &most) > 1 ? (long)(most * JOB_FLOATS) : 0;
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

// a packing job: dst [planes][rows][pitch] from src (plane, row and column strides sp, sr, sc), zero past
// src_rows and src_cols (the pitch pitch8(cols) unless given)
void add_job(std::vector<PackJob>& jobs, const void* src, bf16_t* dst, long long sp, long long sr, long long sc,
             int planes, int rows, int cols, int src_rows, int src_cols, int kind, int H, int pitch = 0) {
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
}

// rows [rows][cols] of src, rows s_row elements apart (any offset), into dst's rows (pitch8(cols) apart
// unless given)
void add_rows(std::vector<PackJob>& jobs, const void* src, bf16_t* dst, long long s_row, int rows, int cols,
              int kind, int pitch = 0) {
  add_job(jobs, src, dst, 0, s_row, 1, 1, rows, cols, rows, cols, kind, 0, pitch);
}

// the weights the recompute reads: W_s [H][half], W_in in the gate's row order [L k][gate_rows(H)][H],
// W_rs [L][2H][H] (the last layer's H rows, then zeros)
void recompute_jobs(const Weights& w, const Shape& sh, bf16_t* w_s, bf16_t* w_in, bf16_t* w_rs,
                    std::vector<PackJob>& jobs) {
  const int H = sh.H, L = sh.L, k = sh.k, half = sh.half, R2 = gate_rows(H);
  add_job(jobs, w.ws, w_s, 0, half, 1, 1, H, half, H, half, P_BF16, H);
  for (int i = 0; i < L; ++i) {
    add_job(jobs, w.win[i], w_in + (size_t)i * k * R2 * pitch8(H), 1, (long long)H * k, k, k, R2, H, 2 * H, H,
            P_GATE, H);
    add_job(jobs, w.wrs[i], w_rs + (size_t)i * 2 * H * pitch8(H), 0, H, 1, 1, 2 * H, H, i + 1 < L ? 2 * H : H, H,
            P_BF16, H);
  }
}

// the backward's: the recompute's, then W_s^T [half][H], W_end^T [H][c_out], W_in transposed [L k][H][2H],
// W_rs^T [L][H][rs_t_cols(H)] (the last layer's skip half zeros)
void weight_jobs(const Weights& w, const Shape& sh, const Bufs& u, std::vector<PackJob>& jobs) {
  const int H = sh.H, L = sh.L, k = sh.k, half = sh.half, C = sh.c_out, rst = rs_t_cols(H);
  recompute_jobs(w, sh, u.w_s, u.w_in, u.w_rs, jobs);
  add_job(jobs, w.ws, u.w_s_t, 0, 1, half, 1, half, H, half, H, P_BF16, H);
  add_job(jobs, w.wend, u.w_end_t, 0, 1, H, 1, H, C, H, C, P_BF16, H);
  for (int i = 0; i < L; ++i) {
    add_job(jobs, w.win[i], u.w_in_t + (size_t)i * k * H * pitch8(2 * H), 1, k, (long long)H * k, k, H, 2 * H, H,
            2 * H, P_BF16, H);
    bf16_t* const rs_t = u.w_rs_t + (size_t)i * H * pitch8(rst);
    add_job(jobs, w.wrs[i], rs_t, 0, 1, H, 1, H, KC * cdiv(H, KC), H, H, P_BF16, H, pitch8(rst));
    add_job(jobs, static_cast<const bf16_t*>(w.wrs[i]) + (size_t)H * H, rs_t + KC * cdiv(H, KC), 0, 1, H, 1, H, H,
            H, i + 1 < L ? H : 0, P_BF16, H, pitch8(rst));
  }
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

bool make_maps(const Shape& sh, const Bufs& u, bool flow, Maps* m) {
  struct Key {
    Bufs u;
    Shape sh;
    int flow;
  } key;
  memset(&key, 0, sizeof(key));
  key.u = u;
  key.sh = sh;
  key.flow = flow;
  return cached_maps(key, m, [&](Maps* out) { return encode_maps(sh, u, flow, out); });
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

// What the recompute reads and writes: the maps of x0 [B], h, acts and the
// packed W_s, W_in, W_rs, and the buffers behind h, acts, skip (bf16), x_in
// [L, B, T, 2H] (fp32; not stored where null), h32 and skip32 (fp32). keep:
// layer i's h and acts at plane i B of their buffers (the backward's weight
// sums read every layer's); otherwise h alternates between planes 0 and B
// and acts keeps plane 0 (the forward).
struct Chain {
  const CUtensorMap *x0, *h, *acts, *w_s, *w_in, *w_rs;
  bf16_t *h_buf, *acts_buf, *skip;
  float *xin, *h32, *skip32;
  bool keep;
};

// The forward's chain up to the skip sum, for the forward and the
// backward's recompute alike: h_0 = START, then per layer GATE (x_in_i,
// acts_i) and RES (h_{i+1} and the skip sum; skip * valid in bf16 after the
// last layer). The same launches with the same tiles either way, so the
// forward's x_in, acts, h and skip sum are the recompute's bits.
cudaError_t recompute(const Shape& sh, const Weights& w, const Chain& c, const int* lens, const long long* seed,
                      unsigned threshold, float keep_scale, cudaStream_t s) {
  const int B = sh.B, T = sh.T, H = sh.H, L = sh.L, k = sh.k;
  const size_t lay = (size_t)B * T, ph = pitch8(H);
  auto h_plane = [&](int i) { return c.keep ? i : i % 2; };
  auto acts_plane = [&](int i) { return c.keep ? i : 0; };

  Gemm p = product(sh, *c.x0, 0, sh.half, *c.w_s, 0, 1, 1, 1, H, lens);  // h_0
  p.bias = w.bs;
  p.f0 = c.h32;
  p.o0 = c.h_buf;
  p.ld0 = (int)ph;
  cudaError_t err = gemm<START>(p, s);
  int dil = 1;
  for (int i = 0; i < L && err == cudaSuccess; ++i, dil *= sh.rate) {
    p = product(sh, *c.h, h_plane(i) * B, H, *c.w_in, i * k, k, dil, 1, 2 * H, lens);  // x_in_i, acts_i
    p.seed = seed;
    p.threshold = threshold;
    p.keep_scale = keep_scale;
    p.layer = i;
    p.bias = w.bin[i];
    p.f0 = c.xin ? c.xin + i * lay * 2 * H : nullptr;
    p.o0 = c.acts_buf + acts_plane(i) * lay * ph;
    p.ld0 = (int)ph;
    err = gemm<GATE>(p, s);
    if (err != cudaSuccess) break;
    const bool last = i + 1 == L;  // h_{i+1}, the skip sum
    p = product(sh, *c.acts, acts_plane(i) * B, H, *c.w_rs, i, 1, 1, 1, last ? H : 2 * H, lens);
    p.bias = w.brs[i];
    p.first = i == 0;
    p.last = last;
    p.f0 = c.h32;
    p.f1 = c.skip32;
    p.o0 = last ? nullptr : c.h_buf + h_plane(i + 1) * lay * ph;
    p.o1 = c.skip;
    p.ld0 = p.ld1 = (int)ph;
    err = gemm<RES>(p, s);
  }
  return err;
}

// The backward's conditioner chain from the packed x0 and g: the
// recompute, dskip, the layers' transposed products in reverse, then (B3)
// dx0 into dx0 or (B6) dxc's first half (g_xc + dh_0 W_s) * valid into the
// scratch.
cudaError_t chain(const Shape& sh, const Weights& w, const Bufs& u, const Maps& m, const int* lens,
                  const long long* seed, unsigned threshold, float keep_scale, const bf16_t* g_xc, bf16_t* dx0,
                  cudaStream_t s) {
  const int B = sh.B, T = sh.T, H = sh.H, L = sh.L, k = sh.k, half = sh.half;
  const size_t lay = (size_t)B * T, ph = pitch8(H), p2h = pitch8(2 * H);
  const int R = B * cdiv(T, TM), Wp = 2 * H > sh.c_out ? 2 * H : sh.c_out;
  auto part = [&](int src) { return u.bias_part + (size_t)src * R * Wp; };

  const Chain c{&m.act[M_X0], &m.act[M_H], &m.act[M_ACTS], &m.w_s, &m.w_in, &m.w_rs, u.h, u.acts, u.skip,
                u.xin, u.h32, u.skip32, true};
  cudaError_t err = recompute(sh, w, c, lens, seed, threshold, keep_scale, s);
  if (err != cudaSuccess) return err;

  Gemm p = product(sh, m.act[M_G], 0, sh.c_out, m.w_end_t, 0, 1, 1, 1, H, lens);  // dskip
  p.o0 = u.dskip;
  p.ld0 = (int)ph;
  p.part = part(0);
  p.part_ld = Wp;
  err = gemm<DSKIP>(p, s);
  for (int i = L - 1; i >= 0 && err == cudaSuccess; --i) {
    int dil = 1;
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

// The bias gradients (the engine's column sums) from part [S][R][Wp], the
// column sums of the R tiles of source s: 0 dskip (H columns: the skip
// half of every layer's drs, all of the last layer's), 1 + i dh_i (H: dbs,
// or the residual half of layer i - 1's drs), 1 + L + i dx_in_i (2H: dbin),
// B6's 1 + 2L daln and 2 + 2L dalb (C, fp32); and g's rows themselves
// (dbend, every frame).
cudaError_t biases(const Shape& sh, const Bufs& u, bf16_t* dbs, bf16_t* const* dbin, bf16_t* const* dbrs,
                   bf16_t* dbend, float* daln, float* dalb, cudaStream_t s) {
  const int L = sh.L, H = sh.H, R = sh.B * cdiv(sh.T, TM), Wp = 2 * H > sh.c_out ? 2 * H : sh.c_out;
  auto part = [&](int src) { return u.bias_part + (size_t)src * R * Wp; };
  std::vector<SumSource> v;
  SumSource skip{part(0), nullptr, R, H, Wp, {}, nullptr};
  for (int i = 0; i + 1 < L; ++i) skip.outs.push_back(dbrs[i] + H);
  skip.outs.push_back(dbrs[L - 1]);
  v.push_back(skip);
  for (int i = 0; i < L; ++i) v.push_back({part(1 + i), nullptr, R, H, Wp, {i == 0 ? dbs : dbrs[i - 1]}, nullptr});
  for (int i = 0; i < L; ++i) v.push_back({part(1 + L + i), nullptr, R, 2 * H, Wp, {dbin[i]}, nullptr});
  if (daln) {
    v.push_back({part(1 + 2 * L), nullptr, R, sh.c_out, Wp, {}, daln});
    v.push_back({part(2 + 2 * L), nullptr, R, sh.c_out, Wp, {}, dalb});
  }
  v.push_back({nullptr, u.g, sh.B * sh.T, sh.c_out, pitch8(sh.c_out), {dbend}, nullptr});
  return column_sums(v, s);
}

// ---- the forward -------------------------------------------------------------------
// The forward's scratch, in ops/wn_coupling.py:FWD16_PARTS order (bf16 but
// for h32, skip32 and xin): x0 packed (B3; B6 where xc's rows cannot be
// read in place), h in min(L, 2) planes, acts in one, skip * valid, h32,
// skip32, x_in (only for return_buffers), the packed W_s, W_in, W_rs and
// W_end [c_out][H], B6's x1 and mt^T [C][C].
struct FwdBufs {
  bf16_t *x0, *h, *acts, *skip;
  float *h32, *skip32, *xin;
  bf16_t *w_s, *w_in, *w_rs, *w_end, *x1, *mt_t;
};

FwdBufs fwd_bufs_of(void* const* b) {
  auto h = [&](int i) { return static_cast<bf16_t*>(b[i]); };
  auto f = [&](int i) { return static_cast<float*>(b[i]); };
  return FwdBufs{h(0), h(1), h(2), h(3), f(4), f(5), f(6), h(7), h(8), h(9), h(10), h(11), h(12)};
}

struct FwdMaps {
  CUtensorMap x0, h, acts, skip, x1, w_s, w_in, w_rs, w_end, mt_t;
};

// x0's map: xc's first half in place (rows C apart) when xc is given, else the packed x0
bool encode_fwd_maps(const Shape& sh, const FwdBufs& u, const bf16_t* xc, FwdMaps* m) {
  const int B = sh.B, T = sh.T, H = sh.H, L = sh.L, k = sh.k, C = sh.c_out, half = sh.half;
  memset(m, 0, sizeof(*m));
  bool ok = (xc ? act_map(&m->x0, xc, half, T, B, C) : act_map(&m->x0, u.x0, half, T, B)) &&
            act_map(&m->h, u.h, H, T, (L < 2 ? L : 2) * B) && act_map(&m->acts, u.acts, H, T, B) &&
            act_map(&m->skip, u.skip, H, T, B) && w_map(&m->w_s, u.w_s, half, H, 1, 64) &&
            w_map(&m->w_in, u.w_in, H, gate_rows(H), L * k, 64) && w_map(&m->w_rs, u.w_rs, H, 2 * H, L, 64) &&
            w_map(&m->w_end, u.w_end, H, C, 1, 64);
  if (u.x1) ok = ok && act_map(&m->x1, u.x1, C, T, B) && w_map(&m->mt_t, u.mt_t, C, C, 1, 64);
  return ok;
}

bool make_fwd_maps(const Shape& sh, const FwdBufs& u, const bf16_t* xc, FwdMaps* m) {
  struct Key {
    FwdBufs u;
    Shape sh;
    const bf16_t* xc;
  } key;
  memset(&key, 0, sizeof(key));
  key.u = u;
  key.sh = sh;
  key.xc = xc;
  return cached_maps(key, m, [&](FwdMaps* out) { return encode_fwd_maps(sh, u, xc, out); });
}

// The packing jobs of the weights the forward reads: the recompute's and W_end [c_out][H].
void forward_weight_jobs(const Weights& w, const Shape& sh, const FwdBufs& u, std::vector<PackJob>& jobs) {
  recompute_jobs(w, sh, u.w_s, u.w_in, u.w_rs, jobs);
  add_job(jobs, w.wend, u.w_end, 0, sh.H, 1, 1, sh.c_out, sh.H, sh.c_out, sh.H, P_BF16, sh.H);
}

// The recompute from x0's map, then out = (skip * valid) W_end + b_end
// [B, T, c_out] contiguous bf16.
cudaError_t forward(const Shape& sh, const Weights& w, const bf16_t* bend, const FwdBufs& u, const FwdMaps& m,
                    const int* lens, const long long* seed, unsigned threshold, float keep_scale, bf16_t* out,
                    cudaStream_t s) {
  const Chain c{&m.x0, &m.h, &m.acts, &m.w_s, &m.w_in, &m.w_rs, u.h, u.acts, u.skip, u.xin, u.h32, u.skip32, false};
  cudaError_t err = recompute(sh, w, c, lens, seed, threshold, keep_scale, s);
  if (err != cudaSuccess) return err;
  Gemm p = product(sh, m.skip, 0, sh.H, m.w_end, 0, 1, 1, 1, sh.c_out, lens);
  p.bias = bend;
  p.o0 = out;
  p.ld0 = sh.c_out;
  return gemm<END>(p, s);
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

// B3's bf16 forward on `stream`; returns a cudaError_t (0 on success). x0
// [B, T, half] bf16 with rows ldx elements apart (any offset), the weights
// contiguous bf16 in PyTorch's layouts; out [B, T, c_out] contiguous bf16;
// `scratch` the pointers of ops/wn_coupling.py:fwd16_layout's parts,
// FWD16_PARTS order (B6's null, xin null unless the caller reads it).
extern "C" int wn_coupling_fwd_bf16(const void* x0, int ldx, const int* lens, const long long* seed, const void* ws,
                                    const void* bs, const void* const* win, const void* const* bin,
                                    const void* const* wrs, const void* const* brs, const void* wend,
                                    const void* bend, void* out, void* const* scratch, int B, int T, int half, int H,
                                    int c_out, int n_layers, int kernel_size, int dilation_rate, unsigned threshold,
                                    float keep_scale, void* stream) {
  using namespace wn16;
  const Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!valid_shape(sh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdBufs u = fwd_bufs_of(scratch);
  if (!u.x0) return (int)cudaErrorInvalidValue;
  using C = const bf16_t*;
  using CP = const bf16_t* const*;
  const Weights w{C(ws), CP(win), CP(wrs), C(wend), C(bs), CP(bin), CP(brs)};
  FwdMaps m;
  if (!make_fwd_maps(sh, u, nullptr, &m)) return (int)cudaErrorInvalidValue;
  std::vector<PackJob> jobs;
  forward_weight_jobs(w, sh, u, jobs);
  add_rows(jobs, x0, u.x0, ldx, B * T, half, P_BF16);
  cudaError_t err = pack(jobs, lens, T, nullptr, nullptr, s);
  if (err == cudaSuccess)
    err = forward(sh, w, C(bend), u, m, lens, seed, threshold, keep_scale, static_cast<bf16_t*>(out), s);
  return (int)err;
}

// B6's bf16 forward on `stream`; returns a cudaError_t. x [B, T, C]
// contiguous bf16 (C = 2 half = c_out); aln, alb [C] and mt [C, C] fp32;
// the conditioner's weights bf16; xc and out [B, T, C] contiguous bf16;
// `scratch` as wn_coupling_fwd_bf16's (x0 null where C is a multiple of 8:
// the conditioner then reads xc's first half in place).
extern "C" int flow_step_fwd_bf16(const void* x, const int* lens, const long long* seed, const float* aln,
                                  const float* alb, const float* mt, const void* ws, const void* bs,
                                  const void* const* win, const void* const* bin, const void* const* wrs,
                                  const void* const* brs, const void* wend, const void* bend, void* xc, void* out,
                                  void* const* scratch, int B, int T, int half, int H, int c_out, int n_layers,
                                  int kernel_size, int dilation_rate, unsigned threshold, float keep_scale,
                                  void* stream) {
  using namespace wn16;
  const Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  const bool in_place = c_out % 8 == 0;  // xc's rows 16-byte multiples apart: TMA reads its first half
  const FwdBufs u = fwd_bufs_of(scratch);
  if (!valid_shape(sh) || c_out != 2 * half || !u.x1 || in_place == (u.x0 != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using C = const bf16_t*;
  using CP = const bf16_t* const*;
  const Weights w{C(ws), CP(win), CP(wrs), C(wend), C(bs), CP(bin), CP(brs)};
  bf16_t* const xc16 = static_cast<bf16_t*>(xc);
  FwdMaps m;
  if (!make_fwd_maps(sh, u, in_place ? xc16 : nullptr, &m)) return (int)cudaErrorInvalidValue;
  std::vector<PackJob> jobs;
  forward_weight_jobs(w, sh, u, jobs);
  add_rows(jobs, x, u.x1, c_out, B * T, c_out, P_ACTNORM);  // x1 = (alb + exp(aln) x) * valid
  add_job(jobs, mt, u.mt_t, 0, 1, c_out, 1, c_out, c_out, c_out, c_out, P_F32, H);  // mt^T, fp32 to bf16
  cudaError_t err = pack(jobs, lens, T, aln, alb, s);
  if (err != cudaSuccess) return (int)err;
  Gemm p = product(sh, m.x1, 0, c_out, m.mt_t, 0, 1, 1, 1, c_out, lens);  // xc = x1 mt, and x0 where not in place
  p.o0 = xc16;
  p.ld0 = c_out;
  if (!in_place) {
    p.o1 = u.x0;
    p.ld1 = pitch8(half);
    p.n1 = half;
  }
  err = gemm<XC>(p, s);
  if (err == cudaSuccess)
    err = forward(sh, w, C(bend), u, m, lens, seed, threshold, keep_scale, static_cast<bf16_t*>(out), s);
  return (int)err;
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
  add_rows(jobs, x0, u.x0, ldx, B * T, half, P_BF16);  // x0 and g into their padded buffers
  add_rows(jobs, g, u.g, c_out, B * T, c_out, P_BF16);
  cudaError_t err = pack(jobs, lens, T, nullptr, nullptr, s);
  if (err == cudaSuccess) err = chain(sh, w, u, m, lens, seed, threshold, keep_scale, nullptr, P(dx0), s);
  if (err == cudaSuccess)
    err = weight_sums(problems(sh, Grads{P(dws), P(dwend), PP(dwin), PP(dwrs), nullptr}, false), B, T, m.act,
                      u.wsum_part, s);
  if (err == cudaSuccess)
    err = biases(sh, u, P(dbs), PP(dbin), PP(dbrs), P(dbend), nullptr, nullptr, s);
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
  add_rows(jobs, g_out, u.g, Cc, B * T, Cc, P_BF16);  // g
  add_rows(jobs, x, u.x1, Cc, B * T, Cc, P_ACTNORM);  // x1 = (alb + exp(aln) x) * valid
  add_rows(jobs, C(g_xc) + half, u.dxc + half, Cc, B * T, Cc - half, P_MASKED, pitch8(Cc));  // dxc's second half
  add_job(jobs, mt, u.mt_t, 0, 1, Cc, 1, half, Cc, half, Cc, P_F32, H);  // mt^T's first half rows [half][C]
  add_job(jobs, mt, u.mt, 0, Cc, 1, 1, Cc, Cc, Cc, Cc, P_F32, H);        // mt [C][C]
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
    err = weight_sums(problems(sh, Grads{P(dws), P(dwend), PP(dwin), PP(dwrs), dmt}, true), B, T, m.act,
                      u.wsum_part, s);
  if (err == cudaSuccess) err = biases(sh, u, P(dbs), PP(dbin), PP(dbrs), P(dbend), daln, dalb, s);
  return (int)err;
}
