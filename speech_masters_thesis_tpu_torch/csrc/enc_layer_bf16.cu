// One Glow-TTS text-encoder layer in bf16 for Hopper (sm_90a), its forward
// and its recompute backward on one engine: every dense product on wgmma
// with both operands bf16, staged by TMA into mbarrier rings (the engine
// B3's and B6's bf16 kernels run: bf16_engine.cuh), attention's products on
// bf16 tensor-core MMA (mma.sync m16n8k16, bf16_mma.cuh), fp32 sums. The
// forward is the backward's recompute, launch for launch (recompute below),
// so the backward differentiates the forward that ran, as in the TPU kernel,
// where _fwd_kernel and _bwd_kernel run one body. The fp32 mode stays in
// enc_layer_fwd.cu and enc_layer_bwd.cu.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/enc_layer.py, functions
// fused_enc_layer -> pallas_call(_fwd_kernel) and _vjp_bwd ->
// pallas_call(_bwd_kernel) (both on _layer_fwd_body), in their bf16 mode
// (dot_dtype bf16). Plain versions: ops/enc_layer.py: enc_layer_reference
// and enc_layer_backward_reference on bf16 tensors. Rounding points, as the
// TPU kernel's: every product's operands bf16 (_dot_nn, _dot_nt, _dot_tn,
// _conv, _conv_t, _conv_wgrad), fp32 sums; the softmax, the LayerNorms and
// their backwards, the relu's derivative, the dropout scales and delta_i =
// sum_j dp_ij p_ij fp32; out and dx written in bf16; the weight gradients
// fp32 sums over every frame cast to bf16 once, the bias and LayerNorm sums
// over their fp32 cotangents.
//
// What it computes, for x [B, T, C] and (backward) the output cotangent g
// (zero at rows at or past len, as the TPU kernel takes it), valid = t < len:
//   forward (the backward's recompute up to z2): xm = x valid; q|k|v = xm
//     [W_q; W_k; W_v]^T + b; per head S = (q k^T + band(q R_k^T)) / sqrt(D),
//     P = softmax (keys past len out), oh = bf16(P keep) v + band(bf16(P
//     keep)) R_v; y = oh W_o^T + b_o; x1 = LN1(xm + y keep_Y); hid =
//     relu(conv_k(x1 valid, W_1) + b_1) keep_M valid; z2 = x1 + (conv_k(hid,
//     W_2) + b_2) valid keep_F; out = LN2(z2)
//   dz2 = LN2^T(g valid); dc2 = dz2 keep_F valid
//   dc1 = conv_k^T(dc2, W_2) where hid > 0, times the keep scale
//   dx1 = dz2 + conv_k^T(dc1, W_1) valid; dz1 = LN1^T(dx1); dy = dz1 keep_Y
//   doh = dy W_o; per head dp = (doh v^T + band(doh R_v^T)) keep_P,
//     delta_i = sum_j dp_ij p_ij, ds = p (dp - delta) / sqrt(D) (valid pairs),
//     dq = bf16(ds) k + bf16(band(ds)) R_k, dk = bf16(ds)^T q,
//     dv = bf16(p keep)^T doh
//   dx = (dz1 + [dq|dk|dv] [W_q; W_k; W_v]) valid
//   weight gradients over the B * T frames: W_{q,k,v} (dq|dk|dv, xm), W_o
//   (dy, oh), W_1 per tap (dc1, x1 valid shifted), W_2 per tap (dc2, hid
//   shifted), R_k (band(ds), q) and R_v (band(p keep), doh) summed over rows
//   and heads, the gains (LN output cotangent times zhat) and the biases as
//   column sums.
//
// What bounds it on an H100: operations, about 3.5 GFLOP (forward) and
// 10.6 GFLOP (backward) over the valid rows and pairs at (8, 256): 0.0036
// and 0.011 ms at 989 TFLOP/s of bf16; the inputs, outputs and weights move
// about 1.5 MB.
//
// Design. The TPU kernel keeps a sequence in VMEM. Here the scratch lives in
// device memory, laid out by the wrapper (ops/enc_layer.py:fwd16_layout and
// bwd16_layout, one allocation a call): what only the products read is
// bf16, exact copies of the operands the TPU kernel rounds (xm, q|k|v, oh,
// x1 valid, hid, dc2, dc1, dy, doh, dq|dk|dv), rows padded to 16 bytes so
// TMA can read them; what fp32 work reads stays fp32 (x1, LN1's zhat and
// 1/std, hid for the relu's sign, dz2, dz1, the softmax statistics and
// delta). One launch packs every weight a call's products read, K-major in
// the layout its product reads, and x masked (the forward: W_q|W_k|W_v,
// their biases, W_o, W_1 and W_2; the backward also their transposes). Each
// dense product is one launch of enc16_gemm_kernel<EPI> on the engine's ring
// (a block: 64 frames of one sequence by 64 output channels, each k-slice's
// wgmmas added to fp32 sums), its epilogue in the accumulators' layout with
// its device-memory inputs loaded before the products. A LayerNorm needs a
// whole 192-channel row, which a 64 x 64 tile does not hold, and 2,048
// rows are 32 row tiles: so W_o's product, the FFN's second conv (2,304
// terms) and W_1's transposed conv (2,304) write fp32 partial sums, the
// long ones over a fixed split of their k-slices that fills the card, and a
// row kernel (a warp a row) adds the splits in order and runs the
// LayerNorm: LN1's forward, LN2's forward with LN2's backward at once (no
// zhat2 leaves the kernel), LN1's backward, and for the forward LN2's
// forward half and out (LN2F, the same code as LN2's); the row kernels and
// the relu-derivative epilogue also write fixed-order column partials of the
// gains' and biases' sums. Attention takes three kernels on 32-row tiles,
// 4 warps (two row groups of 16 rows, each over half of every staged tile
// of the other side, their partials added in a fixed order), bf16 row tiles
// double buffered by cp.async and read as MMA fragments as they lie or by
// ldmatrix.trans: the recompute (two passes over the keys: each row's max and sum, then
// bf16(P keep) V, so that P is rounded normalised as the TPU kernel
// rounds it), dq (a first pass for delta_i = sum_j dp_ij p_ij, which has to
// be whole before any ds: under the rounding doh . oh is not it, and
// keeping a 64-row tile's p and dp over up to 512 keys would take 256 KB of
// shared memory; the second pass dq += bf16(ds) K) and dk/dv (one pass over
// the query tiles). The band's R_k and R_v terms are small products on the
// same MMA: q R_k^T and doh R_v^T as a tile's band dots, band(P) R_v and
// band(ds) R_k from the band values the passes leave in shared memory; the
// R_k and R_v gradients a tile's fixed-order partial on the CUDA cores. No
// [T, T] tensor touches device memory. The weight gradients are the
// engine's weight sums (wn16_wsum_kernel: the frames as wgmma's K), the
// biases, gains and tables one fixed-order sum of the partials (the
// engine's column sums, wn16_bias_kernel). No float atomics: two calls are bitwise equal.
// Launches a call: the forward a pack, q|k|v, attention, W_o, LN1, conv 1,
// conv 2 and LN2F: 8; the backward a pack, 8 products, 3 row kernels, 3
// attention kernels, the weight sums (and their reduction where the frames
// are split) and the biases: 17 or 18.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "bf16_engine.cuh"
#include "bf16_mma.cuh"
#include "hash.cuh"

namespace enc16 {

using namespace wn16;

constexpr int C = 192;            // ops/_build.py ENC_CHANNELS
constexpr int D = 96;             // ops/_build.py ENC_HEAD_DIM
constexpr int MAX_WINDOW = 8;     // ops/_build.py ENC_MAX_WINDOW
constexpr int ENC_STREAMS = 64;   // ops/enc_layer.py ENC_STREAMS
constexpr int SITE_ATTN_P = 0, SITE_ATTN_Y = 1, SITE_FFN_MID = 2, SITE_FFN_Y = 3;

__host__ __device__ constexpr int pitch4(int c) { return (c + 3) / 4 * 4; }  // an fp32 row: 16-byte multiple

__device__ __forceinline__ float drop_at(uint32_t key, unsigned threshold, float keep_scale, uint32_t counter) {
  if (!threshold) return 1.0f;
  return hash_draw(key, counter) >= threshold ? keep_scale : 0.0f;
}

__device__ __forceinline__ uint32_t site_key(const long long* seed, unsigned threshold, int b, int stream) {
  return threshold ? stream_key((uint32_t)seed[0], (uint32_t)(b * ENC_STREAMS + stream)) : 0u;
}

// ---- the dense products ---------------------------------------------------------------
//   QKV    o0 = sum + bias (bf16)
//   PART   f0[split] = sum (fp32 partials of a split of the k-slices)
//   FFN1   hid = relu(sum + bias) keep_M valid: o0 (bf16) and, where set, f0
//          (fp32: the backward's relu signs)
//   DRELU  o0 = r32 > 0 ? sum * keep scale : 0 (bf16; r32 = hid), its column
//          sums to part
//   DOH    o0 = sum (bf16)
//   DX     o0 = (r32 + sum) valid (bf16; r32 = dz1)
enum Epi : int { QKV, PART, FFN1, DRELU, DOH, DX };

struct Gemm {
  CUtensorMap a[2], w;
  int taps, dil, sign, ch0, ch1;  // the engine's product (load_slice); ch1 = 0
  int a_plane[2], w_plane;
  int B, T, ntt, n_out, per_split;  // per_split: the k-slices of a split (blockIdx.z)
  const int* lens;
  const long long* seed;
  unsigned threshold;
  float keep_scale;
  const bf16_t* bias;
  bf16_t* o0;  // rows ld0 apart
  int ld0;
  float* f0;  // rows ldf apart (PART: split z's partial at f0 + z split_ld)
  const float* r32;  // rows ldf apart
  int ldf;
  long long split_ld;
  float* part;  // DRELU: a row tile's column sums, part_ld floats a row
  int part_ld;
};

template <int EPI>
__global__ void __launch_bounds__(THREADS) enc16_gemm_kernel(const __grid_constant__ Gemm p) {
  using S = GemmSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + S::BAR_OFF);
  float* const red = reinterpret_cast<float*>(sm + S::RED_OFF);
  const int b = blockIdx.x / p.ntt, t0 = (blockIdx.x % p.ntt) * TM, n0 = blockIdx.y * BN;
  const int ns = p.taps * (p.ch0 + p.ch1), s0 = blockIdx.z * p.per_split;
  const int n = max(0, min(ns, s0 + p.per_split) - s0);
  ring_init(full);
  auto load = [&](int k) {
    if (k < n) load_slice(p, sm, full, k, s0 + k, b, t0, n0);
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < RING; ++k) load(k);

  // sum[r]: row 16 warp + lane / 4 + 8 ((r / 2) % 2), column 8 (r / 4) + 2 (lane % 4) + r % 2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  const int len = min(p.lens[b], p.T);
  const size_t base = (size_t)b * p.T;
  auto row_of = [&](int r) { return t0 + row0 + 8 * ((r >> 1) & 1); };
  auto col_of = [&](int r) { return n0 + 8 * (r >> 2) + col0; };

  // the epilogue's device-memory input (hid, dz1), loaded before the products
  float pre[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; r += 2) {
    pre[r] = pre[r + 1] = 0.f;
    const int t = row_of(r), c = col_of(r);
    if constexpr (EPI == DRELU || EPI == DX) {
      if (t < p.T && c < p.n_out) {
        const float2 v = ld2(p.r32 + (base + t) * p.ldf + c, c + 1 < p.n_out);
        pre[r] = v.x;
        pre[r + 1] = v.y;
      }
    }
  }

  float sum[BN / 2];
  ring_products(sm, full, n, load, sum);

  const uint32_t key = EPI == FFN1 ? site_key(p.seed, p.threshold, b, SITE_FFN_MID * 16) : 0u;
  float v[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; r += 2) {
    v[r] = v[r + 1] = 0.f;
    const int t = row_of(r), c = col_of(r);
    if (t >= p.T || c >= p.n_out) continue;
    const bool two = c + 1 < p.n_out;
    const size_t row = base + t;
    const float valid = t < len ? 1.0f : 0.0f;
    float x0 = sum[r], x1 = two ? sum[r + 1] : 0.0f;
    if constexpr (EPI == QKV) {
      x0 += f32(p.bias[c]);
      x1 = two ? x1 + f32(p.bias[c + 1]) : 0.0f;
      st2(p.o0 + row * p.ld0 + c, x0, x1, two);
    } else if constexpr (EPI == PART) {
      st2(p.f0 + (size_t)blockIdx.z * p.split_ld + row * p.ldf + c, x0, x1, two);
    } else if constexpr (EPI == FFN1) {
      const uint32_t at = (uint32_t)t * (uint32_t)p.n_out + (uint32_t)c;
      x0 = fmaxf(x0 + f32(p.bias[c]), 0.0f) * drop_at(key, p.threshold, p.keep_scale, at) * valid;
      x1 = two ? fmaxf(x1 + f32(p.bias[c + 1]), 0.0f) * drop_at(key, p.threshold, p.keep_scale, at + 1) * valid
               : 0.0f;
      if (p.f0) st2(p.f0 + row * p.ldf + c, x0, x1, two);
      st2(p.o0 + row * p.ld0 + c, x0, x1, two);
    } else if constexpr (EPI == DRELU) {
      const float ks = p.threshold ? p.keep_scale : 1.0f;
      x0 = pre[r] > 0.0f ? x0 * ks : 0.0f;
      x1 = pre[r + 1] > 0.0f ? x1 * ks : 0.0f;
      v[r] = x0;
      v[r + 1] = x1;
      st2(p.o0 + row * p.ld0 + c, x0, x1, two);
    } else if constexpr (EPI == DOH) {
      st2(p.o0 + row * p.ld0 + c, x0, x1, two);
    } else {  // DX
      st2(p.o0 + row * p.ld0 + c, (pre[r] + x0) * valid, (pre[r + 1] + x1) * valid, two);
    }
  }
  if constexpr (EPI == DRELU) col_sums(v, red, p.part + (size_t)blockIdx.x * p.part_ld + n0, p.n_out - n0);
}

template <int EPI>
cudaError_t gemm(const Gemm& p, int splits, cudaStream_t s) {
  constexpr int smem = GemmSmem::BYTES;
  const cudaError_t err = allow_smem<enc16_gemm_kernel<EPI>>(smem);
  if (err != cudaSuccess) return err;
  enc16_gemm_kernel<EPI><<<dim3(p.B * p.ntt, cdiv(p.n_out, BN), splits), THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// ---- the LayerNorm rows -----------------------------------------------------------------
//   LN1F  y = (sum of the splits + b_o) keep_Y; z1 = x valid + y; x1 = LN1(z1):
//         x1, x1 valid (bf16), and where set zhat1, 1/std (the backward's)
//   LN2   y2 = (sum + b_2) valid keep_F; z2 = x1 + y2; LN2's statistics, then
//         its backward for g valid: dz2, dc2 = dz2 keep_F valid (bf16);
//         column partials of g valid zhat2 (g2), g valid (be2), dc2 (b2)
//   LN1B  dx1 = dz2 + sum valid; dz1 = LN1^T(dx1); dy = dz1 keep_Y valid
//         (bf16); column partials of dx1 zhat1 (g1), dx1 (be1), dy (b_o)
//   LN2F  the forward's end: z2 and its statistics by LN2's code, then out =
//         LN2(z2) (bf16)
// A warp a row, each lane 6 of the 192 channels (lane + 32 i); a block 8
// warps, a row each; the block's column partials summed over its warps in
// order.
enum RowMode : int { LN1F, LN2, LN1B, LN2F };
constexpr int CPL = C / 32;
constexpr int ROW_WARPS = 8, ROWS_PER_WARP = 1, ROW_BLOCK = ROW_WARPS * ROWS_PER_WARP;

struct Rows {
  int T, rows, splits, R;  // R: the row blocks (column partials' rows)
  long long split_ld;
  const int* lens;
  const long long* seed;
  unsigned threshold;
  float keep_scale, eps;
  const float* part;  // the product's split partials [splits][rows][C]
  const bf16_t *bias, *gamma, *beta, *x, *g;
  float *x1, *zhat1, *rinv1, *dz2, *dz1;
  bf16_t *x1m, *dc2, *dy, *out;
  float* cols;  // [3][R][C]
};

template <int MODE>
__global__ void __launch_bounds__(ROW_WARPS * 32) enc16_rows_kernel(const __grid_constant__ Rows p) {
  __shared__ float red[ROW_WARPS][3][C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[3][CPL];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[k][i] = 0.f;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int row = blockIdx.x * ROW_BLOCK + warp * ROWS_PER_WARP + rr;
    if (row >= p.rows) break;
    const int b = row / p.T, t = row % p.T;
    const float valid = t < min(p.lens[b], p.T) ? 1.0f : 0.0f;
    float z[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      float s = 0.f;
      for (int k = 0; k < p.splits; ++k) s += p.part[(size_t)k * p.split_ld + (size_t)row * C + c];
      z[i] = s;
    }
    auto row_sum = [](float s) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
      return s;
    };
    if constexpr (MODE != LN1B) {  // LN2F runs LN2's forward half: z2's statistics are the backward's
      const uint32_t key = site_key(p.seed, p.threshold, b, (MODE == LN1F ? SITE_ATTN_Y : SITE_FFN_Y) * 16);
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        const float drop = drop_at(key, p.threshold, p.keep_scale, (uint32_t)t * C + c);
        float v;
        if constexpr (MODE == LN1F)
          v = (z[i] + f32(p.bias[c])) * drop + f32(p.x[(size_t)row * C + c]) * valid;
        else
          v = (z[i] + f32(p.bias[c])) * valid * drop + p.x1[(size_t)row * C + c];
        z[i] = v;
        s += v;
        sq += v * v;
      }
      s = row_sum(s);
      sq = row_sum(sq);
      const float mean = s / C;
      const float inv = rsqrtf(fmaxf(sq / C - mean * mean, 0.0f) + p.eps);
      if constexpr (MODE == LN1F) {
        if (lane == 0 && p.rinv1) p.rinv1[row] = inv;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          const float zh = (z[i] - mean) * inv;
          const float x1 = zh * f32(p.gamma[c]) + f32(p.beta[c]);
          if (p.zhat1) p.zhat1[(size_t)row * C + c] = zh;
          p.x1[(size_t)row * C + c] = x1;
          p.x1m[(size_t)row * C + c] = __float2bfloat16_rn(x1 * valid);
        }
      } else if constexpr (MODE == LN2F) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          const float zh = (z[i] - mean) * inv;
          p.out[(size_t)row * C + c] = __float2bfloat16_rn(zh * f32(p.gamma[c]) + f32(p.beta[c]));
        }
      } else {  // LN2's backward for g valid
        float zh[CPL], dyl[CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          zh[i] = (z[i] - mean) * inv;
          const float gm = valid > 0.f ? f32(p.g[(size_t)row * C + c]) : 0.0f;
          z[i] = gm;
          dyl[i] = gm * f32(p.gamma[c]);
          s1 += dyl[i];
          s2 += dyl[i] * zh[i];
        }
        s1 = row_sum(s1);
        s2 = row_sum(s2);
        const float m1 = s1 / C, m2 = s2 / C;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          const float dz = inv * (dyl[i] - m1 - zh[i] * m2);
          const float dc = dz * drop_at(key, p.threshold, p.keep_scale, (uint32_t)t * C + c) * valid;
          p.dz2[(size_t)row * C + c] = dz;
          p.dc2[(size_t)row * C + c] = __float2bfloat16_rn(dc);
          acc[0][i] += z[i] * zh[i];
          acc[1][i] += z[i];
          acc[2][i] += dc;
        }
      }
    } else {  // LN1B
      const uint32_t key = site_key(p.seed, p.threshold, b, SITE_ATTN_Y * 16);
      const float inv = p.rinv1[row];
      float zh[CPL], dyl[CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        const float dx1 = p.dz2[(size_t)row * C + c] + z[i] * valid;
        z[i] = dx1;
        zh[i] = p.zhat1[(size_t)row * C + c];
        dyl[i] = dx1 * f32(p.gamma[c]);
        s1 += dyl[i];
        s2 += dyl[i] * zh[i];
      }
      s1 = row_sum(s1);
      s2 = row_sum(s2);
      const float m1 = s1 / C, m2 = s2 / C;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        const float dz = inv * (dyl[i] - m1 - zh[i] * m2);
        const float dy = dz * drop_at(key, p.threshold, p.keep_scale, (uint32_t)t * C + c) * valid;
        p.dz1[(size_t)row * C + c] = dz;
        p.dy[(size_t)row * C + c] = __float2bfloat16_rn(dy);
        acc[0][i] += z[i] * zh[i];
        acc[1][i] += z[i];
        acc[2][i] += dy;
      }
    }
  }
  if constexpr (MODE == LN1F || MODE == LN2F) return;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < CPL; ++i) red[warp][k][lane + 32 * i] = acc[k][i];
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * C; e += ROW_WARPS * 32) {
    const int k = e / C, c = e % C;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) s += red[w][k][c];
    p.cols[((size_t)k * p.R + blockIdx.x) * C + c] = s;
  }
}

template <int MODE>
cudaError_t rows(const Rows& p, cudaStream_t s) {
  enc16_rows_kernel<MODE><<<p.R, ROW_WARPS * 32, 0, s>>>(p);
  return cudaGetLastError();
}

// ---- attention ------------------------------------------------------------------------------
// Tiles of 32 rows (queries, or keys for dk/dv) a block, 4 warps: warp w
// takes rows 16 (w % 2) .. + 15 of the tile and half w / 2 of every staged
// tile of the other side (keys, or queries for dk/dv), so each row's sums
// over that side are two partials, added in a fixed order at the end. A
// warp's products are m16n8k16 bf16 MMAs (bf16_mma.cuh), each k-step's MMA
// added to fp32 accumulators (mma.sync's accumulation truncates). Tiles
// stay [rows][D] bf16 in shared memory, rows LDR apart, double buffered by
// cp.async: the A operands and the B of a product over D as they lie, the B
// of a product over the rows by ldmatrix.trans.
constexpr int AR = 32;           // rows a block
constexpr int ANT = 128;         // threads a block: 2 row groups x 2 halves of the other side
constexpr int KT = 64;           // rows of the other side a staged tile, 32 a half
constexpr int KS = D / 16;       // k-steps over the head
constexpr int DN = D / 8;        // n8 tiles over the head
constexpr int LDR = D + 8;       // [row][d]: 208 bytes, conflict-free fragment and ldmatrix reads
constexpr int RB = 24;           // band dots a row: 2w + 1 <= 17 in three n8 tiles
constexpr int LDB = 40;          // [row][o] band values (o < 32: two k-steps) and [d][o] tables
constexpr int TILE_BYTES = KT * LDR * 2;

__device__ __forceinline__ uint32_t pr(const bf16_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t s = smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[j] += A B^T over KSN k-steps for the n8 tiles j < min(NJ, j_end): A
// the warp's 16 rows of a tile from `a` (rows lda apart), B a [n][k] tile
template <int NJ, int KSN>
__device__ __forceinline__ void mma_nt(float (&acc)[NJ][4], const bf16_t* a, int lda, const bf16_t* bt, int ldb,
                                       int j_end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KSN; ++kk) {
    const bf16_t* ap = a + g * lda + 16 * kk + 2 * qd;
    const uint32_t af[4] = {pr(ap), pr(ap + 8 * lda), pr(ap + 8), pr(ap + 8 * lda + 8)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= j_end) continue;
      const bf16_t* bp = bt + (8 * j + g) * ldb + 16 * kk + 2 * qd;
      const uint32_t bf[2] = {pr(bp), pr(bp + 8)};
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      bf16::mma(part, af, bf);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
    }
  }
}

// out[dn] += bf16(X) B over the head: X the warp's [16][8 NJ] values in the
// accumulator layout (its columns the k, k-steps below kk_end), B a [k][D]
// tile of rows LDR apart, its fragments by ldmatrix.trans (two n8 tiles a load)
template <int NJ>
__device__ __forceinline__ void mma_xb(float (&out)[DN][4], const float (&x)[NJ][4], const bf16_t* rows,
                                       int kk_end) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    if (kk >= kk_end) break;
    const uint32_t af[4] = {bf16::pack(x[2 * kk][0], x[2 * kk][1]), bf16::pack(x[2 * kk][2], x[2 * kk][3]),
                            bf16::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            bf16::pack(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const bf16_t* base = rows + (16 * kk + 8 * (mi & 1) + r8) * LDR + 8 * (mi >> 1);
#pragma unroll
    for (int d2 = 0; d2 < DN / 2; ++d2) {
      uint32_t b[4];
      bf16::ldsm_x4_t(b, base + 16 * d2);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
      bf16::mma(p0, af, b0);
      bf16::mma(p1, af, b1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[2 * d2][e] += p0[e];
        out[2 * d2 + 1][e] += p1[e];
      }
    }
  }
}

// rows r0 .. r0 + N - 1 of a head (rows ld elements apart, 16-byte aligned;
// zeros at or past `end`) into `rows` ([N][LDR]) by cp.async (committed by
// the caller)
template <int N>
__device__ __forceinline__ void stage(bf16_t* rows, const bf16_t* src, size_t ld, int r0, int end) {
  for (int f = threadIdx.x; f < N * (D / 8); f += ANT) {
    const int r = f / (D / 8), c8 = 8 * (f % (D / 8));
    const bool in = r0 + r < end;
    cp_async16(rows + r * LDR + c8, in ? src + (size_t)(r0 + r) * ld + c8 : src, in);
  }
}

// a table R [nrel][D] (bf16, the layer's R_k or R_v) as RB zero-padded rows
// ([RB][LDR], the B of q R^T) and/or transposed ([D][LDB], the B of band R)
__device__ __forceinline__ void stage_table(bf16_t* rows, bf16_t* cols, const bf16_t* table, int nrel) {
  const bf16_t zero = __float2bfloat16_rn(0.0f);
  if (rows)
    for (int e = threadIdx.x; e < RB * D; e += ANT) {
      const int o = e / D, d = e % D;
      rows[o * LDR + d] = o < nrel ? table[o * D + d] : zero;
    }
  if (cols)
    for (int e = threadIdx.x; e < D * 32; e += ANT) {
      const int d = e / 32, o = e % 32;
      cols[d * LDB + o] = o < nrel ? table[o * D + d] : zero;
    }
}

struct Att {
  const bf16_t* qkv;   // [B, T, 3C]
  const bf16_t* doh;   // [B, T, C]
  const bf16_t *rk, *rv;
  const int* lens;
  const long long* seed;
  unsigned threshold;
  float keep_scale, scale;
  int T, H, window, nat;
  bf16_t* oh;          // the recompute's heads' output [B, T, C]
  float* stats;        // [B, H, T, 4]: max, sum, delta (the recompute's only where set)
  float *qr, *dr;      // [B, H, T, RB]: q R_k^T, doh R_v^T
  bf16_t* dqkv;        // [B, T, 3C]
  bf16_t *dclog, *bandp;  // [B, T, ldband]: head h's band at h (2w + 1)
  int ldband;
  float* bias_part;    // [3][B nat][C]: dq's, dk's, dv's column sums a tile
  float* band_part;    // [2][B H nat][nrel D]: R_k's, R_v's gradients a tile
};

__device__ __forceinline__ float keep_pair(const Att& p, uint32_t key, int r, int c) {
  return drop_at(key, p.threshold, p.keep_scale, (uint32_t)r * (uint32_t)p.T + (uint32_t)c);
}

// The halves' [16][D] accumulators added in a fixed order (half 0's, then
// half 1's, through `comb`, [DN 4][2 row groups][32 lanes]): half 0's warps
// hold the sums after it. Every thread of the block calls it.
__device__ __forceinline__ void add_halves(float (&acc)[DN][4], float* comb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rg = warp & 1, half = warp >> 1;
  if (half == 1)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) comb[((dn * 4 + e) * 2 + rg) * 32 + lane] = acc[dn][e];
  __syncthreads();
  if (half == 0)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] += comb[((dn * 4 + e) * 2 + rg) * 32 + lane];
  __syncthreads();
}

// a tile's column sums over its rows (half 0's warps' accumulators, two
// rows a thread of 2 adjacent columns an n8 tile), into out[d]
__device__ __forceinline__ void head_col_sums(const float (&v)[DN][4], float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = v[dn][e] + v[dn][2 + e];
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 4);
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 8);
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 16);
        if (lane < 4) red[warp * D + 8 * dn + 2 * lane + e] = s;
      }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += ANT) out[d] = red[d] + red[D + d];
  __syncthreads();
}

// rows r .. r + 8 (the thread's two) of a warp's [16][D] accumulators in bf16
// to dst (rows ld apart), zeros at rows at or past len, none at or past T
__device__ __forceinline__ void store_head(bf16_t* dst, size_t ld, const float (&acc)[DN][4], int r, int len, int T) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= T) continue;
    const bool ok = row < len;
    bf16_t* out = dst + (size_t)row * ld + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<uint32_t*>(out + 8 * dn) =
          bf16::pack(ok ? acc[dn][2 * h] : 0.f, ok ? acc[dn][2 * h + 1] : 0.f);
  }
}

// the band dots of the tile's 32 rows, A's rows (16 a row group) against a
// table's RB padded rows, by the warps of half 0, into dots [AR][RB]
__device__ __forceinline__ void band_dots(const bf16_t* a, const bf16_t* table_rows, float* dots) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  if (warp >= 2) return;
  float acc[3][4] = {};
  mma_nt<3, KS>(acc, a + 16 * warp * LDR, LDR, table_rows, LDR, 3);
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dots[(16 * warp + g + 8 * (e >> 1)) * RB + 8 * j + 2 * qd + (e & 1)] = acc[j][e];
}

struct AttFwdSmem {
  static constexpr int QS = 0, KS_ = QS + AR * LDR * 2, VS = KS_ + 2 * TILE_BYTES, RK = VS + 2 * TILE_BYTES;
  static constexpr int RVT = RK + RB * LDR * 2, QR = RVT + D * LDB * 2, BP = QR + AR * RB * 4;
  static constexpr int ML = BP + AR * LDB * 2, COMB = ML + 2 * AR * 2 * 4;
  static constexpr int BYTES = COMB + DN * 4 * 2 * 32 * 4;
};

// The recompute's attention: oh and, where stats is set, each row's softmax
// (max, sum).
template <bool DROP>
__global__ void __launch_bounds__(ANT, 1) enc16_att_fwd_kernel(const __grid_constant__ Att p) {
  using S = AttFwdSmem;
  extern __shared__ __align__(16) uint8_t smem_att[];
  bf16_t* const qs = reinterpret_cast<bf16_t*>(smem_att + S::QS);
  bf16_t* const rk = reinterpret_cast<bf16_t*>(smem_att + S::RK);
  bf16_t* const rvt = reinterpret_cast<bf16_t*>(smem_att + S::RVT);
  float* const qr = reinterpret_cast<float*>(smem_att + S::QR);
  bf16_t* const bp = reinterpret_cast<bf16_t*>(smem_att + S::BP);
  float* const ml = reinterpret_cast<float*>(smem_att + S::ML);
  float* const comb = reinterpret_cast<float*>(smem_att + S::COMB);
  auto ks = [&](int it) { return reinterpret_cast<bf16_t*>(smem_att + S::KS_ + (it & 1) * TILE_BYTES); };
  auto vs = [&](int it) { return reinterpret_cast<bf16_t*>(smem_att + S::VS + (it & 1) * TILE_BYTES); };
  const int q0 = blockIdx.x * AR, h = blockIdx.y, b = blockIdx.z, T = p.T, H = p.H, w = p.window;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qd = lane & 3;
  const int rg = warp & 1, half = warp >> 1;
  const int len = min(p.lens[b], T), nrel = 2 * w + 1;
  const size_t ld = 3 * C, head = (size_t)b * T * ld + (size_t)h * D;
  const uint32_t key = DROP ? site_key(p.seed, p.threshold, b, SITE_ATTN_P * 16 + h) : 0u;
  const int kend = q0 < len ? len : 0, n_tiles = cdiv(kend, KT);  // a tile of padded rows visits no key

  stage<AR>(qs, p.qkv + head, ld, q0, T);
  if (n_tiles > 0) stage<KT>(ks(0), p.qkv + head + C, ld, 0, len);
  cp_async_commit();
  stage_table(rk, nullptr, p.rk, nrel);
  stage_table(nullptr, rvt, p.rv, nrel);
  for (int e = threadIdx.x; e < AR * LDB; e += ANT) bp[e] = __float2bfloat16_rn(0.0f);
  cp_async_wait<0>();
  __syncthreads();
  band_dots(qs, rk, qr);
  __syncthreads();
  const int lr0 = 16 * rg + (lane >> 2);  // the thread's rows lr0 and lr0 + 8 of the tile
  const bf16_t* const qa = qs + 16 * rg * LDR;
  auto score = [&](float acc, int e, int col) {  // the masked, scaled score of (row e / 2, key col), -inf outside
    const int lr = lr0 + 8 * (e >> 1), row = q0 + lr, off = col - row;
    if (row >= len || col >= len) return -INFINITY;
    const float rel = off >= -w && off <= w ? qr[lr * RB + off + w] : 0.0f;
    return (acc + rel) * p.scale;
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {  // pass 1: each row's max and sum over this half's keys
    if (it + 1 < n_tiles) stage<KT>(ks(it + 1), p.qkv + head + C, ld, (it + 1) * KT, len);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kb = it * KT + 32 * half, j_end = min(4, max(0, cdiv(len - kb, 8)));
    if (j_end > 0) {
      float s[4][4] = {};
      mma_nt<4, KS>(s, qa, LDR, ks(it) + 32 * half * LDR, LDR, j_end);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = score(s[j][e], e, kb + 8 * j + 2 * qd + (e & 1));
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s[j][e] != -INFINITY) sum[e >> 1] += expf(s[j][e] - m_new[e >> 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xFFFFFFFFu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xFFFFFFFFu, sum[r], 2);
        l[r] = (m_new[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - m_new[r])) + sum[r];
        m[r] = m_new[r];
      }
    }
    __syncthreads();
  }
  // the halves' (max, sum) of each row, combined in a fixed order
  if (qd == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ml[(half * AR + lr0 + 8 * r) * 2] = m[r];
      ml[(half * AR + lr0 + 8 * r) * 2 + 1] = l[r];
    }
  if (n_tiles > 0) {  // pass 2's first tiles
    stage<KT>(ks(0), p.qkv + head + C, ld, 0, len);
    stage<KT>(vs(0), p.qkv + head + 2 * C, ld, 0, len);
  }
  cp_async_commit();
  __syncthreads();
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* a = ml + (lr0 + 8 * r) * 2;
    const float* c = ml + (AR + lr0 + 8 * r) * 2;
    const float mm = fmaxf(a[0], c[0]);
    const float ll = (a[0] == -INFINITY ? 0.f : a[1] * expf(a[0] - mm)) + (c[0] == -INFINITY ? 0.f : c[1] * expf(c[0] - mm));
    m[r] = mm;
    l[r] = ll;
    inv_l[r] = 1.0f / ll;
  }

  float acc[DN][4] = {};
  for (int it = 0; it < n_tiles; ++it) {  // pass 2: oh = bf16(P keep) V, the band's values kept
    if (it + 1 < n_tiles) {
      stage<KT>(ks(it + 1), p.qkv + head + C, ld, (it + 1) * KT, len);
      stage<KT>(vs(it + 1), p.qkv + head + 2 * C, ld, (it + 1) * KT, len);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kb = it * KT + 32 * half, j_end = min(4, max(0, cdiv(len - kb, 8)));
    if (j_end > 0) {
      float s[4][4] = {};
      mma_nt<4, KS>(s, qa, LDR, ks(it) + 32 * half * LDR, LDR, j_end);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kb + 8 * j + 2 * qd + (e & 1), lr = lr0 + 8 * (e >> 1), row = q0 + lr, off = col - row;
          const float sc = score(s[j][e], e, col);
          float pd = 0.f;
          if (sc != -INFINITY) {
            pd = expf(sc - m[e >> 1]) * inv_l[e >> 1];
            if (DROP) pd *= keep_pair(p, key, row, col);
            if (off >= -w && off <= w) bp[lr * LDB + off + w] = __float2bfloat16_rn(pd);
          }
          s[j][e] = pd;
        }
      mma_xb<4>(acc, s, vs(it) + 32 * half * LDR, cdiv(j_end, 2));
    }
    __syncthreads();
  }
  add_halves(acc, comb);
  if (half == 0) {
    mma_nt<DN, 2>(acc, bp + 16 * rg * LDB, LDB, rvt, LDB, DN);  // + band(bf16(P keep)) R_v
    store_head(p.oh + (size_t)b * T * C + (size_t)h * D, C, acc, q0 + lr0, len, T);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + lr0 + 8 * r;
      if (row < T && qd == 0 && p.stats) {
        float* st = p.stats + (((size_t)b * H + h) * T + row) * 4;
        st[0] = m[r];
        st[1] = l[r];
      }
    }
  }
}

struct AttDqSmem {
  static constexpr int QS = 0, GS = QS + AR * LDR * 2, KS_ = GS + AR * LDR * 2, VS = KS_ + 2 * TILE_BYTES;
  static constexpr int RK = VS + 2 * TILE_BYTES, RV = RK + RB * LDR * 2, RKT = RV + RB * LDR * 2;
  static constexpr int QR = RKT + D * LDB * 2, DR = QR + AR * RB * 4, DCL = DR + AR * RB * 4;
  static constexpr int BPD = DCL + AR * LDB * 2, DL = BPD + AR * LDB * 2, RED = DL + 2 * AR * 4;
  static constexpr int COMB = RED + 2 * D * 4, BYTES = COMB + DN * 4 * 2 * 32 * 4;
};

// dq, delta, the band dots, the band values and the R_k / R_v partials.
template <bool DROP>
__global__ void __launch_bounds__(ANT, 1) enc16_att_dq_kernel(const __grid_constant__ Att p) {
  using S = AttDqSmem;
  extern __shared__ __align__(16) uint8_t smem_att[];
  bf16_t* const qs = reinterpret_cast<bf16_t*>(smem_att + S::QS);
  bf16_t* const gs = reinterpret_cast<bf16_t*>(smem_att + S::GS);
  bf16_t* const rk = reinterpret_cast<bf16_t*>(smem_att + S::RK);
  bf16_t* const rv = reinterpret_cast<bf16_t*>(smem_att + S::RV);
  bf16_t* const rkt = reinterpret_cast<bf16_t*>(smem_att + S::RKT);
  float* const qr = reinterpret_cast<float*>(smem_att + S::QR);
  float* const dr = reinterpret_cast<float*>(smem_att + S::DR);
  bf16_t* const dcl = reinterpret_cast<bf16_t*>(smem_att + S::DCL);
  bf16_t* const bpd = reinterpret_cast<bf16_t*>(smem_att + S::BPD);
  float* const dls = reinterpret_cast<float*>(smem_att + S::DL);
  float* const red = reinterpret_cast<float*>(smem_att + S::RED);
  float* const comb = reinterpret_cast<float*>(smem_att + S::COMB);
  auto ks = [&](int it) { return reinterpret_cast<bf16_t*>(smem_att + S::KS_ + (it & 1) * TILE_BYTES); };
  auto vs = [&](int it) { return reinterpret_cast<bf16_t*>(smem_att + S::VS + (it & 1) * TILE_BYTES); };
  const int q0 = blockIdx.x * AR, h = blockIdx.y, b = blockIdx.z, T = p.T, H = p.H, w = p.window;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qd = lane & 3;
  const int rg = warp & 1, half = warp >> 1;
  const int len = min(p.lens[b], T), nrel = 2 * w + 1;
  const size_t ld = 3 * C, head = (size_t)b * T * ld + (size_t)h * D, ohead = (size_t)b * T * C + (size_t)h * D;
  const size_t row_st = ((size_t)b * H + h) * T;
  const uint32_t key = DROP ? site_key(p.seed, p.threshold, b, SITE_ATTN_P * 16 + h) : 0u;
  const int kend = q0 < len ? len : 0, n_tiles = cdiv(kend, KT);
  auto stage_kv = [&](int it) {
    if (it < n_tiles) {
      stage<KT>(ks(it), p.qkv + head + C, ld, it * KT, len);
      stage<KT>(vs(it), p.qkv + head + 2 * C, ld, it * KT, len);
    }
    cp_async_commit();
  };

  stage<AR>(qs, p.qkv + head, ld, q0, T);
  stage<AR>(gs, p.doh + ohead, C, q0, T);
  cp_async_commit();
  stage_kv(0);  // pass 1's first tile, in flight through the prologue
  stage_table(rk, rkt, p.rk, nrel);
  stage_table(rv, nullptr, p.rv, nrel);
  for (int e = threadIdx.x; e < AR * LDB; e += ANT) dcl[e] = bpd[e] = __float2bfloat16_rn(0.0f);
  cp_async_wait<1>();
  __syncthreads();
  band_dots(qs, rk, qr);  // the tile's q R_k^T and doh R_v^T, also for the dk/dv kernel
  band_dots(gs, rv, dr);
  __syncthreads();
  for (int e = threadIdx.x; e < AR * RB; e += ANT) {
    const int row = q0 + e / RB;
    if (row < T) {
      p.qr[(row_st + q0) * RB + e] = qr[e];
      p.dr[(row_st + q0) * RB + e] = dr[e];
    }
  }
  const int lr0 = 16 * rg + (lane >> 2);
  const bf16_t* const qa = qs + 16 * rg * LDR;
  const bf16_t* const ga = gs + 16 * rg * LDR;
  // the thread's two rows' max and 1/sum (scalars: kept in registers)
  const int row0 = q0 + lr0, row1 = row0 + 8;
  const float m0 = row0 < len ? p.stats[(row_st + row0) * 4] : 0.f;
  const float m1 = row1 < len ? p.stats[(row_st + row1) * 4] : 0.f;
  const float il0 = row0 < len ? 1.0f / p.stats[(row_st + row0) * 4 + 1] : 0.f;
  const float il1 = row1 < len ? 1.0f / p.stats[(row_st + row1) * 4 + 1] : 0.f;
  // p and dp keep of the half's element (j, e) at keys from kb; p = 0 at an invalid pair
  auto probs = [&](float (&s)[4][4], float (&dp)[4][4], int kb) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kb + 8 * j + 2 * qd + (e & 1), lr = lr0 + 8 * (e >> 1), row = q0 + lr, off = col - row;
        const bool valid = row < len && col < len, band = off >= -w && off <= w;
        const float sc = (s[j][e] + (band ? qr[lr * RB + off + w] : 0.f)) * p.scale;
        const float pv = valid ? expf(sc - (e >> 1 ? m1 : m0)) * (e >> 1 ? il1 : il0) : 0.f;
        const float kf = DROP ? (valid ? keep_pair(p, key, row, col) : 0.f) : 1.f;
        dp[j][e] = (dp[j][e] + (band ? dr[lr * RB + off + w] : 0.f)) * kf;
        s[j][e] = pv;
      }
  };

  float dl0 = 0.f, dl1 = 0.f;
  for (int it = 0; it < n_tiles; ++it) {  // pass 1: delta_i = sum_j dp_ij p_ij over this half's keys
    stage_kv(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int kb = it * KT + 32 * half, j_end = min(4, max(0, cdiv(len - kb, 8)));
    if (j_end > 0) {
      float s[4][4] = {}, dp[4][4] = {};
      mma_nt<4, KS>(s, qa, LDR, ks(it) + 32 * half * LDR, LDR, j_end);
      mma_nt<4, KS>(dp, ga, LDR, vs(it) + 32 * half * LDR, LDR, j_end);
      probs(s, dp, kb);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dl0 += dp[j][e] * s[j][e];
          dl1 += dp[j][2 + e] * s[j][2 + e];
        }
    }
    __syncthreads();
  }
  dl0 += __shfl_xor_sync(0xFFFFFFFFu, dl0, 1);
  dl0 += __shfl_xor_sync(0xFFFFFFFFu, dl0, 2);
  dl1 += __shfl_xor_sync(0xFFFFFFFFu, dl1, 1);
  dl1 += __shfl_xor_sync(0xFFFFFFFFu, dl1, 2);
  if (qd == 0) {
    dls[half * AR + lr0] = dl0;
    dls[half * AR + lr0 + 8] = dl1;
  }
  stage_kv(0);  // pass 2's first tile
  __syncthreads();
  dl0 = dls[lr0] + dls[AR + lr0];  // the halves' partials in a fixed order
  dl1 = dls[lr0 + 8] + dls[AR + lr0 + 8];
  if (half == 0 && qd == 0) {
    if (row0 < T) p.stats[(row_st + row0) * 4 + 2] = row0 < len ? dl0 : 0.f;
    if (row1 < T) p.stats[(row_st + row1) * 4 + 2] = row1 < len ? dl1 : 0.f;
  }

  float acc[DN][4] = {};
  for (int it = 0; it < n_tiles; ++it) {  // pass 2: dq = bf16(ds) K, the band's ds and P keep kept
    stage_kv(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int kb = it * KT + 32 * half, j_end = min(4, max(0, cdiv(len - kb, 8)));
    if (j_end > 0) {
      float s[4][4] = {}, dp[4][4] = {};
      mma_nt<4, KS>(s, qa, LDR, ks(it) + 32 * half * LDR, LDR, j_end);
      mma_nt<4, KS>(dp, ga, LDR, vs(it) + 32 * half * LDR, LDR, j_end);
      probs(s, dp, kb);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kb + 8 * j + 2 * qd + (e & 1), lr = lr0 + 8 * (e >> 1), row = q0 + lr, off = col - row;
          const float pv = s[j][e];
          const float ds = pv * (dp[j][e] - (e >> 1 ? dl1 : dl0)) * p.scale;  // 0 at an invalid pair: pv = 0
          if (row < len && col < len && off >= -w && off <= w) {
            dcl[lr * LDB + off + w] = __float2bfloat16_rn(ds);
            const float kf = DROP ? keep_pair(p, key, row, col) : 1.f;
            bpd[lr * LDB + off + w] = __float2bfloat16_rn(pv * kf);
          }
          s[j][e] = ds;
        }
      mma_xb<4>(acc, s, ks(it) + 32 * half * LDR, cdiv(j_end, 2));
    }
    __syncthreads();
  }
  add_halves(acc, comb);
  if (half == 0) {
    mma_nt<DN, 2>(acc, dcl + 16 * rg * LDB, LDB, rkt, LDB, DN);  // + bf16(band(ds)) R_k
    store_head(p.dqkv + (size_t)b * T * ld + (size_t)h * D, ld, acc, q0 + lr0, len, T);
  }
  head_col_sums(acc, red, p.bias_part + ((size_t)b * p.nat + blockIdx.x) * C + h * D);
  for (int e = threadIdx.x; e < AR * nrel; e += ANT) {  // the band values, for the masks' read-back
    const int lr = e / nrel, o = e % nrel, row = q0 + lr;
    if (row >= T) continue;
    const size_t at = ((size_t)b * T + row) * p.ldband + h * nrel + o;
    p.dclog[at] = dcl[lr * LDB + o];
    p.bandp[at] = bpd[lr * LDB + o];
  }
  // the tile's R_k and R_v gradients: sum over its rows of band(ds)[o] q[d], band(P keep)[o] doh[d]
  const size_t part = ((size_t)b * H + h) * p.nat + blockIdx.x;
  const size_t second = (size_t)gridDim.z * H * p.nat * nrel * D;
  for (int e = threadIdx.x; e < nrel * D; e += ANT) {
    const int o = e / D, d = e % D;
    float a = 0.f, c = 0.f;
    for (int r = 0; r < AR; ++r) {
      a = fmaf(f32(dcl[r * LDB + o]), f32(qs[r * LDR + d]), a);
      c = fmaf(f32(bpd[r * LDB + o]), f32(gs[r * LDR + d]), c);
    }
    p.band_part[part * nrel * D + e] = a;
    p.band_part[second + part * nrel * D + e] = c;
  }
}

struct AttDkdvSmem {
  static constexpr int KS_ = 0, VS = KS_ + AR * LDR * 2, QS = VS + AR * LDR * 2, GS = QS + 2 * TILE_BYTES;
  static constexpr int QR = GS + 2 * TILE_BYTES, DR = QR + 2 * KT * RB * 4, ST = DR + 2 * KT * RB * 4;
  static constexpr int RED = ST + 2 * KT * 4 * 4, COMB = RED + 2 * D * 4, BYTES = COMB + DN * 4 * 2 * 32 * 4;
};

// dk and dv of a tile of keys over every query tile.
template <bool DROP>
__global__ void __launch_bounds__(ANT, 1) enc16_att_dkdv_kernel(const __grid_constant__ Att p) {
  using S = AttDkdvSmem;
  extern __shared__ __align__(16) uint8_t smem_att[];
  bf16_t* const ks = reinterpret_cast<bf16_t*>(smem_att + S::KS_);
  bf16_t* const vs = reinterpret_cast<bf16_t*>(smem_att + S::VS);
  float* const red = reinterpret_cast<float*>(smem_att + S::RED);
  float* const comb = reinterpret_cast<float*>(smem_att + S::COMB);
  auto qs = [&](int it) { return reinterpret_cast<bf16_t*>(smem_att + S::QS + (it & 1) * TILE_BYTES); };
  auto gs = [&](int it) { return reinterpret_cast<bf16_t*>(smem_att + S::GS + (it & 1) * TILE_BYTES); };
  auto qr = [&](int it) { return reinterpret_cast<float*>(smem_att + S::QR + (it & 1) * KT * RB * 4); };
  auto dr = [&](int it) { return reinterpret_cast<float*>(smem_att + S::DR + (it & 1) * KT * RB * 4); };
  auto st = [&](int it) { return reinterpret_cast<float*>(smem_att + S::ST + (it & 1) * KT * 4 * 4); };
  const int c0 = blockIdx.x * AR, h = blockIdx.y, b = blockIdx.z, T = p.T, H = p.H, w = p.window;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, qd = lane & 3;
  const int rg = warp & 1, half = warp >> 1;
  const int len = min(p.lens[b], T);
  const size_t ld = 3 * C, head = (size_t)b * T * ld + (size_t)h * D, ohead = (size_t)b * T * C + (size_t)h * D;
  const size_t row_st = ((size_t)b * H + h) * T;
  const uint32_t key = DROP ? site_key(p.seed, p.threshold, b, SITE_ATTN_P * 16 + h) : 0u;
  const int rend = c0 < len ? len : 0, n_tiles = cdiv(rend, KT);  // a tile of padded keys visits no query
  auto stage_q = [&](int it) {  // query tile it: q, doh, the band dots and (max, sum, delta), zeros past len
    if (it < n_tiles) {
      const int r0 = it * KT;
      stage<KT>(qs(it), p.qkv + head, ld, r0, len);
      stage<KT>(gs(it), p.doh + ohead, C, r0, len);
      for (int f = threadIdx.x; f < KT * (RB / 4); f += ANT) {
        const int r = f / (RB / 4), c4 = 4 * (f % (RB / 4));
        const bool in = r0 + r < len;
        const size_t at = (row_st + r0 + r) * RB + c4;
        cp_async16(qr(it) + r * RB + c4, in ? p.qr + at : p.qr, in);
        cp_async16(dr(it) + r * RB + c4, in ? p.dr + at : p.dr, in);
      }
      for (int r = threadIdx.x; r < KT; r += ANT) {
        const bool in = r0 + r < len;
        cp_async16(st(it) + 4 * r, in ? p.stats + (row_st + r0 + r) * 4 : p.stats, in);
      }
    }
    cp_async_commit();
  };

  stage<AR>(ks, p.qkv + head + C, ld, c0, len);
  stage<AR>(vs, p.qkv + head + 2 * C, ld, c0, len);
  stage_q(0);
  const int kl0 = 16 * rg + (lane >> 2);  // the thread's keys c0 + kl0 and c0 + kl0 + 8
  const bf16_t* const ka = ks + 16 * rg * LDR;
  const bf16_t* const va = vs + 16 * rg * LDR;
  float dka[DN][4] = {}, dva[DN][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    stage_q(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int rb = it * KT + 32 * half, j_end = min(4, max(0, cdiv(len - rb, 8)));
    if (j_end > 0) {
      const float* const sq = qr(it);
      const float* const sd = dr(it);
      const float* const sst = st(it);
      float s[4][4] = {}, dp[4][4] = {};
      mma_nt<4, KS>(s, ka, LDR, qs(it) + 32 * half * LDR, LDR, j_end);   // S^T: keys by queries
      mma_nt<4, KS>(dp, va, LDR, gs(it) + 32 * half * LDR, LDR, j_end);  // (doh V^T)^T
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + kl0 + 8 * (e >> 1), i = 32 * half + 8 * j + 2 * qd + (e & 1), row = it * KT + i;
          const int off = col - row;
          const bool valid = col < len && row < len, band = off >= -w && off <= w;
          const float sc = (s[j][e] + (band ? sq[i * RB + off + w] : 0.f)) * p.scale;
          const float pv = valid ? expf(sc - sst[4 * i]) / sst[4 * i + 1] : 0.f;
          const float kf = DROP ? (valid ? keep_pair(p, key, row, col) : 0.f) : 1.f;
          const float dpv = (dp[j][e] + (band ? sd[i * RB + off + w] : 0.f)) * kf;
          s[j][e] = pv * (dpv - sst[4 * i + 2]) * p.scale;  // dS^T
          dp[j][e] = pv * kf;                                 // (P keep)^T
        }
      mma_xb<4>(dva, dp, gs(it) + 32 * half * LDR, cdiv(j_end, 2));
      mma_xb<4>(dka, s, qs(it) + 32 * half * LDR, cdiv(j_end, 2));
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  add_halves(dka, comb);
  add_halves(dva, comb);
  if (half == 0) {
    store_head(p.dqkv + (size_t)b * T * ld + C + (size_t)h * D, ld, dka, c0 + kl0, len, T);
    store_head(p.dqkv + (size_t)b * T * ld + 2 * C + (size_t)h * D, ld, dva, c0 + kl0, len, T);
  }
  const size_t tile = ((size_t)b * p.nat + blockIdx.x) * C + h * D, plane = (size_t)gridDim.z * p.nat * C;
  head_col_sums(dka, red, p.bias_part + plane + tile);
  head_col_sums(dva, red, p.bias_part + 2 * plane + tile);
}

template <class Kernel>
cudaError_t attention_launch(Kernel kernel, int bytes, const Att& p, int B, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.nat, p.H, B), ANT, bytes, s>>>(p);
  return cudaGetLastError();
}

// ---- host ----------------------------------------------------------------------------------
struct Shape {
  int B, T, heads, window, F, k;
  float eps;
};

bool valid_shape(const Shape& s) {
  return s.B >= 1 && s.B <= 65535 && s.T >= 1 && s.heads * D == C && s.window >= 0 && s.window <= MAX_WINDOW &&
         s.F >= 1 && (s.k == 1 || s.k == 3 || s.k == 5);
}

// the k-slices of the 2,304-deep products a split (ops/enc_layer.py:bwd16_splits), 0 for a split that
// leaves one empty
int split_depth(const Shape& s, int splits) {
  const int slices = s.k * cdiv(s.F, KC), per = splits >= 1 ? cdiv(slices, splits) : 0;
  return per >= 1 && cdiv(slices, per) == splits ? per : 0;
}

// the backward's scratch, in ops/enc_layer.py:BWD16_PARTS order: bf16 rows
// pitch8 of their width, fp32 rows pitch4
enum Part : int {
  S_W_QKV, S_B_QKV, S_W_QKV_T, S_W_O, S_W_O_T, S_W_1, S_W_1_T, S_W_2, S_W_2_T, S_XM, S_QKV, S_OH, S_X1M, S_HID16, S_DC2,
  S_DC1, S_DY, S_DOH, S_DQKV,
  S_DCLOG, S_BANDP, S_STATS, S_QR, S_DR, S_X1, S_ZHAT1, S_RINV1, S_HID, S_DZ2, S_DZ1, S_SPLIT_PART, S_ROW_PART, S_B1_PART, S_ATT_PART,
  S_BAND_PART, S_WSUM_PART, S_N_PARTS
};

// the forward's scratch, in ops/enc_layer.py:FWD16_PARTS order (F_HID only
// for the caller's return_buffers, else null)
enum FwdPart : int {
  F_W_QKV, F_B_QKV, F_W_O, F_W_1, F_W_2, F_XM, F_QKV, F_OH, F_X1M, F_HID16, F_X1, F_SPLIT_PART, F_HID, F_N_PARTS
};

// the weights and their gradients, in ops/enc_layer.py:PARAM_NAMES order
enum Param : int { WQ, BQ, WK, BK, WV, BV, RK, RV, WO, BO, G1, BE1, W1, B1, W2, B2, G2, BE2, N_PARAMS };

enum WMap : int { M_XM, M_DQ, M_DK, M_DV, M_OH, M_DY, M_X1M, M_DC1, M_H, M_DC2 };

struct Maps {
  CUtensorMap act[W_MAPS];
  CUtensorMap dqkv;  // dq|dk|dv as one source of 3C channels (dx's product)
  CUtensorMap w_qkv, w_qkv_t, w_o, w_o_t, w_1, w_1_t, w_2, w_2_t;
};

struct FwdMaps {
  CUtensorMap xm, oh, x1m, hid16, w_qkv, w_o, w_1, w_2;
};

template <class T_>
T_* part(void* const* scratch, int i) {
  return static_cast<T_*>(scratch[i]);
}

bool encode_maps(const Shape& sh, void* const* u, Maps* m) {
  const int B = sh.B, T = sh.T, F = sh.F, k = sh.k;
  auto h = [u](int i) { return part<bf16_t>(u, i); };
  bool ok = act_map(&m->act[M_XM], h(S_XM), C, T, B) && act_map(&m->act[M_DQ], h(S_DQKV), C, T, B, 3 * C) &&
            act_map(&m->act[M_DK], h(S_DQKV) + C, C, T, B, 3 * C) &&
            act_map(&m->act[M_DV], h(S_DQKV) + 2 * C, C, T, B, 3 * C) && act_map(&m->act[M_OH], h(S_OH), C, T, B) &&
            act_map(&m->act[M_DY], h(S_DY), C, T, B) && act_map(&m->act[M_X1M], h(S_X1M), C, T, B) &&
            act_map(&m->act[M_DC1], h(S_DC1), F, T, B) && act_map(&m->act[M_H], h(S_HID16), F, T, B) &&
            act_map(&m->act[M_DC2], h(S_DC2), C, T, B) && act_map(&m->dqkv, h(S_DQKV), 3 * C, T, B);
  ok = ok && w_map(&m->w_qkv, h(S_W_QKV), C, 3 * C, 1, 64) && w_map(&m->w_qkv_t, h(S_W_QKV_T), 3 * C, C, 1, 64) &&
       w_map(&m->w_o, h(S_W_O), C, C, 1, 64) && w_map(&m->w_o_t, h(S_W_O_T), C, C, 1, 64) &&
       w_map(&m->w_1, h(S_W_1), C, F, k, 64) && w_map(&m->w_1_t, h(S_W_1_T), F, C, k, 64) &&
       w_map(&m->w_2, h(S_W_2), F, C, k, 64) && w_map(&m->w_2_t, h(S_W_2_T), C, F, k, 64);
  return ok;
}

bool encode_fwd_maps(const Shape& sh, void* const* u, FwdMaps* m) {
  const int B = sh.B, T = sh.T, F = sh.F, k = sh.k;
  auto h = [u](int i) { return part<bf16_t>(u, i); };
  return act_map(&m->xm, h(F_XM), C, T, B) && act_map(&m->oh, h(F_OH), C, T, B) &&
         act_map(&m->x1m, h(F_X1M), C, T, B) && act_map(&m->hid16, h(F_HID16), F, T, B) &&
         w_map(&m->w_qkv, h(F_W_QKV), C, 3 * C, 1, 64) && w_map(&m->w_o, h(F_W_O), C, C, 1, 64) &&
         w_map(&m->w_1, h(F_W_1), C, F, k, 64) && w_map(&m->w_2, h(F_W_2), F, C, k, 64);
}

// A call's maps, from the engine's cache (cached_maps); the key holds every
// scratch pointer and the shape.
template <int N>
struct Key {
  void* u[N];
  Shape sh;
};

bool make_maps(const Shape& sh, void* const* u, Maps* m) {
  Key<S_N_PARTS> key;
  memset(&key, 0, sizeof(key));
  for (int i = 0; i < S_N_PARTS; ++i) key.u[i] = u[i];
  key.sh = sh;
  return cached_maps(key, m, [&](Maps* out) { return encode_maps(sh, u, out); });
}

bool make_fwd_maps(const Shape& sh, void* const* u, FwdMaps* m) {
  Key<F_N_PARTS> key;
  memset(&key, 0, sizeof(key));
  for (int i = 0; i < F_N_PARTS; ++i) key.u[i] = u[i];
  key.sh = sh;
  return cached_maps(key, m, [&](FwdMaps* out) { return encode_fwd_maps(sh, u, out); });
}

// The weight-gradient problems (pointers may be null when only the blocks are wanted).
std::vector<WProb> problems(const Shape& sh, void* const* d) {
  const int F = sh.F, k = sh.k, pad = (k - 1) / 2;
  auto grad = [d](int i) { return d ? static_cast<bf16_t*>(d[i]) : nullptr; };
  auto at = [](bf16_t* q, size_t off) { return q ? (void*)(q + off) : nullptr; };
  std::vector<WProb> v;
  const int dmap[3] = {M_DQ, M_DK, M_DV}, wgrad[3] = {WQ, WK, WV};
  for (int i = 0; i < 3; ++i)  // dW[n, c] = sum dq[t, n] xm[t, c]
    v.push_back(wprob(grad(wgrad[i]), 0, dmap[i], 0, 0, C, M_XM, 0, C, C, 1));
  v.push_back(wprob(grad(WO), 0, M_DY, 0, 0, C, M_OH, 0, C, C, 1));  // dW_o[n, c] = sum dy[t, n] oh[t, c]
  for (int j = 0; j < k; ++j) {
    // dW_1[f, c, j] = sum x1m[t + j - pad, c] dc1[t, f]; dW_2[c, f, j] = sum hid[t + j - pad, f] dc2[t, c]
    v.push_back(wprob(at(grad(W1), j), 0, M_X1M, 0, j - pad, C, M_DC1, 0, F, k, C * k));
    v.push_back(wprob(at(grad(W2), j), 0, M_H, 0, j - pad, F, M_DC2, 0, C, k, F * k));
  }
  return v;
}

long wsum_part_floats(const Shape& sh) {
  std::vector<WProb> v = problems(sh, nullptr);
  long long most;
  return assign(v, sh.B, sh.T, &most) > 1 ? (long)(most * JOB_FLOATS) : 0;
}

// one packing job: src's element (j, r, c) at j sp + r sr + c sc into dst (rows `pitch` apart)
void pack_job(std::vector<PackJob>& jobs, const void* src, bf16_t* dst, long long sp, long long sr, long long sc,
              int planes, int rows, int cols, int pitch, int kind) {
  PackJob J{};
  J.src = src;
  J.dst = dst;
  J.s_plane = sp;
  J.s_row = sr;
  J.s_col = sc;
  J.planes = planes;
  J.rows = J.src_rows = rows;
  J.cols = J.src_cols = cols;
  J.pitch = pitch;
  J.kind = kind;
  jobs.push_back(J);
}

// Where the recompute's packed operands go: W_q|W_k|W_v, their biases, W_o,
// W_1 and W_2 tap-major, each K-major as its product reads it, and x masked.
struct Packed {
  bf16_t *w_qkv, *b_qkv, *w_o, *w_1, *w_2, *xm;
};

// the packing jobs of what the recompute reads
void recompute_jobs(const Shape& sh, const void* x, const void* const* w, const Packed& d,
                    std::vector<PackJob>& jobs) {
  const int F = sh.F, k = sh.k, BT = sh.B * sh.T;
  const int wi[3] = {WQ, WK, WV}, bi[3] = {BQ, BK, BV};
  for (int i = 0; i < 3; ++i) {
    pack_job(jobs, w[wi[i]], d.w_qkv + (size_t)i * C * C, 0, C, 1, 1, C, C, C, P_BF16);  // [3C][C]: W_i[n][c]
    pack_job(jobs, w[bi[i]], d.b_qkv + (size_t)i * C, 0, 0, 1, 1, 1, C, 3 * C, P_BF16);  // [3C]
  }
  pack_job(jobs, w[WO], d.w_o, 0, C, 1, 1, C, C, C, P_BF16);                             // [C][C]: W_o[n][c]
  pack_job(jobs, w[W1], d.w_1, 1, (long long)C * k, k, k, F, C, pitch8(C), P_BF16);      // [k][F][C]: W_1[f, c, j]
  pack_job(jobs, w[W2], d.w_2, 1, (long long)F * k, k, k, C, F, pitch8(F), P_BF16);      // [k][C][F]: W_2[c, f, j]
  pack_job(jobs, x, d.xm, 0, C, 1, 1, BT, C, C, P_MASKED);                               // x valid
}

// the backward's: the recompute's, then the transposes its products read
void backward_jobs(const Shape& sh, const void* x, const void* const* w, void* const* u,
                   std::vector<PackJob>& jobs) {
  const int F = sh.F, k = sh.k;
  auto h = [u](int i) { return part<bf16_t>(u, i); };
  recompute_jobs(sh, x, w, Packed{h(S_W_QKV), h(S_B_QKV), h(S_W_O), h(S_W_1), h(S_W_2), h(S_XM)}, jobs);
  const int wi[3] = {WQ, WK, WV};
  for (int i = 0; i < 3; ++i)  // [C][3C]: W_i[n][c] at (c, iC + n)
    pack_job(jobs, w[wi[i]], h(S_W_QKV_T) + (size_t)i * C, 0, 1, C, 1, C, C, 3 * C, P_BF16);
  pack_job(jobs, w[WO], h(S_W_O_T), 0, 1, C, 1, C, C, C, P_BF16);                        // [C][C]: W_o[n][c] at (c, n)
  pack_job(jobs, w[W1], h(S_W_1_T), 1, k, (long long)C * k, k, C, F, pitch8(F), P_BF16);  // [k][C][F]
  pack_job(jobs, w[W2], h(S_W_2_T), 1, k, (long long)F * k, k, F, C, pitch8(C), P_BF16);  // [k][F][C]
}

// A product over one source and its epilogue's common fields.
Gemm product(const Shape& sh, const CUtensorMap& a, int cin, const CUtensorMap& w, int taps, int sign, int n_out,
             const int* lens, int per_split) {
  Gemm p{};
  p.a[0] = p.a[1] = a;
  p.ch0 = cdiv(cin, KC);
  p.w = w;
  p.taps = taps;
  p.dil = 1;
  p.sign = sign;
  p.B = sh.B;
  p.T = sh.T;
  p.ntt = cdiv(sh.T, TM);
  p.n_out = n_out;
  p.lens = lens;
  p.per_split = per_split > 0 ? per_split : taps * p.ch0;
  return p;
}

// The dropout's and the shape's fields of the attention kernels.
struct Dropout {
  const int* lens;
  const long long* seed;
  unsigned threshold;
  float keep_scale;
};

Att attention(const Shape& sh, const bf16_t* qkv, const void* const* w, const Dropout& d) {
  Att a{};
  a.qkv = qkv;
  a.rk = static_cast<const bf16_t*>(w[RK]);
  a.rv = static_cast<const bf16_t*>(w[RV]);
  a.lens = d.lens;
  a.seed = d.seed;
  a.threshold = d.threshold;
  a.keep_scale = d.keep_scale;
  a.scale = 1.0f / sqrtf((float)D);
  a.T = sh.T;
  a.H = sh.heads;
  a.window = sh.window;
  a.nat = cdiv(sh.T, AR);
  return a;
}

cudaError_t attention_fwd(const Att& a, int B, cudaStream_t s) {
  return a.threshold ? attention_launch(enc16_att_fwd_kernel<true>, AttFwdSmem::BYTES, a, B, s)
                     : attention_launch(enc16_att_fwd_kernel<false>, AttFwdSmem::BYTES, a, B, s);
}

// The LayerNorm row kernels' common fields (x: the layer's input).
Rows rows_of(const Shape& sh, const void* x, const Dropout& d) {
  const int BT = sh.B * sh.T;
  Rows r{};
  r.T = sh.T;
  r.rows = BT;
  r.R = cdiv(BT, ROW_BLOCK);
  r.split_ld = (long long)BT * C;
  r.lens = d.lens;
  r.seed = d.seed;
  r.threshold = d.threshold;
  r.keep_scale = d.keep_scale;
  r.eps = sh.eps;
  r.x = static_cast<const bf16_t*>(x);
  return r;
}

// What the recompute reads and writes: the maps of xm, oh, x1m, hid16 and
// the packed weights; the buffers behind the activations and b_qkv; x1 and
// the split partials (fp32); the stores only the backward reads, made where
// set: each row's softmax (max, sum), LN1's zhat and 1/std, the fp32 hid.
struct Chain {
  const CUtensorMap *xm, *oh, *x1m, *hid16, *w_qkv, *w_o, *w_1, *w_2;
  const bf16_t* b_qkv;
  bf16_t *qkv, *oh_buf, *x1m_buf, *hid16_buf;
  float *x1, *split_part, *stats, *zhat1, *rinv1, *hid;
};

// The layer's forward up to z2's split partials, for the forward and the
// backward's recompute alike: q|k|v, attention, W_o's product, LN1's
// forward, the FFN's first conv with its relu, dropout and mask, and its
// second conv's partials over `splits` of its k-slices. The same launches
// with the same tiles either way, so the forward's q|k|v, oh, x1, x1m, hid
// and partials are the recompute's bits.
cudaError_t recompute(const Shape& sh, const void* x, const void* const* w, const Chain& c, const Dropout& d,
                      int splits, cudaStream_t s) {
  const int B = sh.B, F = sh.F, k = sh.k, BT = B * sh.T, per = split_depth(sh, splits);
  auto wb = [w](int i) { return static_cast<const bf16_t*>(w[i]); };

  Gemm p = product(sh, *c.xm, C, *c.w_qkv, 1, 1, 3 * C, d.lens, 0);  // q|k|v
  p.bias = c.b_qkv;
  p.o0 = c.qkv;
  p.ld0 = 3 * C;
  cudaError_t err = gemm<QKV>(p, 1, s);
  if (err != cudaSuccess) return err;

  Att a = attention(sh, c.qkv, w, d);
  a.oh = c.oh_buf;
  a.stats = c.stats;
  if ((err = attention_fwd(a, B, s)) != cudaSuccess) return err;

  // W_o, then LN1's forward
  p = product(sh, *c.oh, C, *c.w_o, 1, 1, C, d.lens, 0);
  p.f0 = c.split_part;
  p.ldf = C;
  p.split_ld = (long long)BT * C;
  if ((err = gemm<PART>(p, 1, s)) != cudaSuccess) return err;
  Rows r = rows_of(sh, x, d);
  r.splits = 1;
  r.part = c.split_part;
  r.bias = wb(BO);
  r.gamma = wb(G1);
  r.beta = wb(BE1);
  r.x1 = c.x1;
  r.zhat1 = c.zhat1;
  r.rinv1 = c.rinv1;
  r.x1m = c.x1m_buf;
  if ((err = rows<LN1F>(r, s)) != cudaSuccess) return err;

  // the FFN: conv 1 with relu, dropout and the mask; conv 2 in splits
  p = product(sh, *c.x1m, C, *c.w_1, k, 1, F, d.lens, 0);
  p.seed = d.seed;
  p.threshold = d.threshold;
  p.keep_scale = d.keep_scale;
  p.bias = wb(B1);
  p.f0 = c.hid;
  p.ldf = pitch4(F);
  p.o0 = c.hid16_buf;
  p.ld0 = pitch8(F);
  if ((err = gemm<FFN1>(p, 1, s)) != cudaSuccess) return err;
  p = product(sh, *c.hid16, F, *c.w_2, k, 1, C, d.lens, per);
  p.f0 = c.split_part;
  p.ldf = C;
  p.split_ld = (long long)BT * C;
  return gemm<PART>(p, splits, s);
}

cudaError_t backward(const Shape& sh, const void* x, const int* lens, const long long* seed, const void* g,
                     const void* const* w, void* dx, void* const* grads, void* const* u, int splits,
                     unsigned threshold, float keep_scale, cudaStream_t s) {
  const int B = sh.B, T = sh.T, F = sh.F, k = sh.k, H = sh.heads, nrel = 2 * sh.window + 1;
  const int BT = B * T, ntt = cdiv(T, TM), nat = cdiv(T, AR), R = cdiv(BT, ROW_BLOCK);
  auto h = [u](int i) { return part<bf16_t>(u, i); };
  auto f = [u](int i) { return part<float>(u, i); };
  auto wb = [w](int i) { return static_cast<const bf16_t*>(w[i]); };
  const Dropout d{lens, seed, threshold, keep_scale};
  Maps m;
  if (!make_maps(sh, u, &m)) return cudaErrorInvalidValue;
  std::vector<PackJob> jobs;
  backward_jobs(sh, x, w, u, jobs);
  cudaError_t err = pack(jobs, lens, T, nullptr, nullptr, s);
  if (err != cudaSuccess) return err;

  // the recompute, keeping what the backward reads
  const Chain c{&m.act[M_XM], &m.act[M_OH], &m.act[M_X1M], &m.act[M_H], &m.w_qkv, &m.w_o, &m.w_1, &m.w_2,
                h(S_B_QKV), h(S_QKV), h(S_OH), h(S_X1M), h(S_HID16), f(S_X1), f(S_SPLIT_PART), f(S_STATS),
                f(S_ZHAT1), f(S_RINV1), f(S_HID)};
  if ((err = recompute(sh, x, w, c, d, splits, s)) != cudaSuccess) return err;
  const int per = split_depth(sh, splits);

  // LN2's forward and backward
  Rows r = rows_of(sh, x, d);
  r.g = static_cast<const bf16_t*>(g);
  r.part = f(S_SPLIT_PART);
  r.x1 = f(S_X1);
  r.zhat1 = f(S_ZHAT1);
  r.rinv1 = f(S_RINV1);
  r.dz2 = f(S_DZ2);
  r.dz1 = f(S_DZ1);
  r.dc2 = h(S_DC2);
  r.dy = h(S_DY);
  Rows r2 = r;
  r2.splits = splits;
  r2.bias = wb(B2);
  r2.gamma = wb(G2);
  r2.cols = f(S_ROW_PART);
  if ((err = rows<LN2>(r2, s)) != cudaSuccess) return err;

  // dc1 = conv^T(dc2, W_2) where the relu kept the row; dx1 = dz2 + conv^T(dc1, W_1) valid in splits, LN1's
  // backward
  Gemm p = product(sh, m.act[M_DC2], C, m.w_2_t, k, -1, F, lens, 0);
  p.threshold = threshold;
  p.keep_scale = keep_scale;
  p.r32 = f(S_HID);
  p.ldf = pitch4(F);
  p.o0 = h(S_DC1);
  p.ld0 = pitch8(F);
  p.part = f(S_B1_PART);
  p.part_ld = pitch4(F);
  if ((err = gemm<DRELU>(p, 1, s)) != cudaSuccess) return err;
  p = product(sh, m.act[M_DC1], F, m.w_1_t, k, -1, C, lens, per);
  p.f0 = f(S_SPLIT_PART);
  p.ldf = C;
  p.split_ld = (long long)BT * C;
  if ((err = gemm<PART>(p, splits, s)) != cudaSuccess) return err;
  Rows r3 = r;
  r3.splits = splits;
  r3.gamma = wb(G1);
  r3.cols = f(S_ROW_PART) + (size_t)3 * R * C;
  if ((err = rows<LN1B>(r3, s)) != cudaSuccess) return err;

  // doh = dy W_o; attention's backward
  p = product(sh, m.act[M_DY], C, m.w_o_t, 1, 1, C, lens, 0);
  p.o0 = h(S_DOH);
  p.ld0 = C;
  if ((err = gemm<DOH>(p, 1, s)) != cudaSuccess) return err;
  Att a = attention(sh, h(S_QKV), w, d);
  a.doh = h(S_DOH);
  a.stats = f(S_STATS);
  a.qr = f(S_QR);
  a.dr = f(S_DR);
  a.dqkv = h(S_DQKV);
  a.dclog = h(S_DCLOG);
  a.bandp = h(S_BANDP);
  a.ldband = pitch8(H * nrel);
  a.bias_part = f(S_ATT_PART);
  a.band_part = f(S_BAND_PART);
  err = threshold ? attention_launch(enc16_att_dq_kernel<true>, AttDqSmem::BYTES, a, B, s)
                  : attention_launch(enc16_att_dq_kernel<false>, AttDqSmem::BYTES, a, B, s);
  if (err != cudaSuccess) return err;
  // same stream: the dk/dv kernel reads the delta and band dots the dq kernel wrote
  err = threshold ? attention_launch(enc16_att_dkdv_kernel<true>, AttDkdvSmem::BYTES, a, B, s)
                  : attention_launch(enc16_att_dkdv_kernel<false>, AttDkdvSmem::BYTES, a, B, s);
  if (err != cudaSuccess) return err;

  // dx = (dz1 + [dq|dk|dv] [W_q; W_k; W_v]) valid
  p = product(sh, m.dqkv, 3 * C, m.w_qkv_t, 1, 1, C, lens, 0);
  p.r32 = f(S_DZ1);
  p.ldf = C;
  p.o0 = static_cast<bf16_t*>(dx);
  p.ld0 = C;
  if ((err = gemm<DX>(p, 1, s)) != cudaSuccess) return err;

  if ((err = weight_sums(problems(sh, grads), B, T, m.act, f(S_WSUM_PART), s)) != cudaSuccess) return err;

  std::vector<SumSource> v;
  auto src = [&](const float* q, int out, int rows_, int width, int ld) {
    v.push_back({q, nullptr, rows_, width, ld, {static_cast<bf16_t*>(grads[out])}, nullptr});
  };
  const float* rp = f(S_ROW_PART);
  const int sources[6] = {G2, BE2, B2, G1, BE1, BO};
  for (int i = 0; i < 6; ++i) src(rp + (size_t)i * R * C, sources[i], R, C, C);
  src(f(S_B1_PART), B1, B * ntt, F, pitch4(F));
  const int qkv_b[3] = {BQ, BK, BV};
  for (int i = 0; i < 3; ++i) src(f(S_ATT_PART) + (size_t)i * B * nat * C, qkv_b[i], B * nat, C, C);
  const size_t band = (size_t)B * H * nat * nrel * D;
  src(f(S_BAND_PART), RK, B * H * nat, nrel * D, nrel * D);
  src(f(S_BAND_PART) + band, RV, B * H * nat, nrel * D, nrel * D);
  return column_sums(v, s);
}

// The forward: one pack of what the recompute reads, the recompute (the
// backward's stores left out; the fp32 hid where the caller reads it back),
// then out = LN2(z2) [B, T, C] bf16.
cudaError_t forward(const Shape& sh, const void* x, const int* lens, const long long* seed, const void* const* w,
                    void* out, void* const* u, int splits, unsigned threshold, float keep_scale, cudaStream_t s) {
  auto h = [u](int i) { return part<bf16_t>(u, i); };
  auto f = [u](int i) { return part<float>(u, i); };
  auto wb = [w](int i) { return static_cast<const bf16_t*>(w[i]); };
  const Dropout d{lens, seed, threshold, keep_scale};
  FwdMaps m;
  if (!make_fwd_maps(sh, u, &m)) return cudaErrorInvalidValue;
  std::vector<PackJob> jobs;
  recompute_jobs(sh, x, w, Packed{h(F_W_QKV), h(F_B_QKV), h(F_W_O), h(F_W_1), h(F_W_2), h(F_XM)}, jobs);
  cudaError_t err = pack(jobs, lens, sh.T, nullptr, nullptr, s);
  if (err != cudaSuccess) return err;
  const Chain c{&m.xm, &m.oh, &m.x1m, &m.hid16, &m.w_qkv, &m.w_o, &m.w_1, &m.w_2, h(F_B_QKV), h(F_QKV), h(F_OH),
                h(F_X1M), h(F_HID16), f(F_X1), f(F_SPLIT_PART), nullptr, nullptr, nullptr, f(F_HID)};
  if ((err = recompute(sh, x, w, c, d, splits, s)) != cudaSuccess) return err;
  Rows r = rows_of(sh, x, d);
  r.splits = splits;
  r.part = f(F_SPLIT_PART);
  r.bias = wb(B2);
  r.gamma = wb(G2);
  r.beta = wb(BE2);
  r.x1 = f(F_X1);
  r.out = static_cast<bf16_t*>(out);
  return rows<LN2F>(r, s);
}

}  // namespace enc16

// Floats of the weight sums' partials that enc_layer_bwd_bf16 needs in its
// scratch (-1 for a shape the kernels do not take); the rest of the scratch
// is ops/enc_layer.py's bwd16_layout.
extern "C" long enc16_wsum_part_floats(int B, int T, int C, int n_heads, int window, int F, int kernel_size) {
  const enc16::Shape sh{B, T, n_heads, window, F, kernel_size, 0.0f};
  if (C != enc16::C || !enc16::valid_shape(sh) || wn16::sm_count() < 1) return -1;
  return enc16::wsum_part_floats(sh);
}

// B5's bf16 forward on `stream`; returns a cudaError_t (0 on success). x
// [B, T, C] contiguous bf16, the 18 weights (`params`, PARAM_NAMES order)
// contiguous bf16 in PyTorch's layouts; out [B, T, C] bf16; `scratch` the
// pointers of ops/enc_layer.py:fwd16_layout's parts (FWD16_PARTS order;
// hid null unless the caller reads it back); `splits` as the backward's
// (ops/enc_layer.py:bwd16_splits).
extern "C" int enc_layer_fwd_bf16(const void* x, const int* lens, const long long* seed, const void* const* params,
                                  void* out, void* const* scratch, int B, int T, int C, int n_heads, int window, int F,
                                  int kernel_size, float eps, unsigned threshold, float keep_scale, int splits,
                                  void* stream) {
  const enc16::Shape sh{B, T, n_heads, window, F, kernel_size, eps};
  if (C != enc16::C || !enc16::valid_shape(sh) || !enc16::split_depth(sh, splits) || wn16::sm_count() < 1)
    return (int)cudaErrorInvalidValue;
  return (int)enc16::forward(sh, x, lens, seed, params, out, scratch, splits, threshold, keep_scale,
                             static_cast<cudaStream_t>(stream));
}

// B5's bf16 backward on `stream`; returns a cudaError_t (0 on success). x
// and g [B, T, C] contiguous bf16, the 18 weights (`params`, PARAM_NAMES
// order) contiguous bf16 in PyTorch's layouts; dx [B, T, C] and the 18
// gradients (`grads`) bf16; `scratch` the pointers of
// ops/enc_layer.py:bwd16_layout's parts (BWD16_PARTS order); `splits` the
// split of the FFN's second conv and W_1's transposed conv over their
// k-slices (ops/enc_layer.py:bwd16_splits).
extern "C" int enc_layer_bwd_bf16(const void* x, const int* lens, const long long* seed, const void* g,
                                  const void* const* params, void* dx, void* const* grads, void* const* scratch,
                                  int B, int T, int C, int n_heads, int window, int F, int kernel_size, float eps,
                                  unsigned threshold, float keep_scale, int splits, void* stream) {
  const enc16::Shape sh{B, T, n_heads, window, F, kernel_size, eps};
  if (C != enc16::C || !enc16::valid_shape(sh) || !enc16::split_depth(sh, splits) || wn16::sm_count() < 1)
    return (int)cudaErrorInvalidValue;
  return (int)enc16::backward(sh, x, lens, seed, g, params, dx, grads, scratch, splits, threshold, keep_scale,
                              static_cast<cudaStream_t>(stream));
}
