// One Glow-TTS text-encoder layer's recompute backward for Hopper (sm_90a),
// fp32 at the interfaces, its products in 3xTF32 on the tensor cores, with
// the forward's dropout masks regenerated in-kernel.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/enc_layer.py, function
// _vjp_bwd -> pallas_call(_bwd_kernel), the custom VJP of fused_enc_layer,
// in its fp32 mode (the bf16 mode is enc_layer_bf16.cu). Plain version:
// ops/enc_layer.py:enc_layer_backward_reference.
//
// What it computes, for the output cotangent g [B, T, C] (zero at rows at or
// past len, as the TPU kernel takes it):
//   recompute (enc_layer_common.cuh), keeping q|k|v, the heads' output oh,
//     each row's softmax (max, sum), LN1's output, both LayerNorms'
//     normalised input and 1/std, and the FFN's hidden rows h after relu,
//     dropout and the mask;
//   dz2 = LN2^T(g);  dc2 = dz2 * keep_F * valid
//   dc1 = conv_k^T(dc2, W_2) * valid * keep_M * relu'   (= 0 unless h > 0)
//   dx1 = dz2 + conv_k^T(dc1, W_1) * valid;  dz1 = LN1^T(dx1);  dy = dz1 * keep_Y
//   doh = dy W_o^T;  per head, with p recomputed from the (max, sum):
//     dp  = (doh_i . v_j + [band] doh_i . R_v[j - i + w]) * keep_P
//     ds  = p * (dp - delta_i) / sqrt(D), delta_i = doh_i . oh_i (oh includes
//           the band's R_v term, so this is rowsum(dp * p) with dropout too)
//     dq_i = sum_j ds k_j + sum_o dclog[i, o] R_k[o], dclog = band(ds)
//     dk_j = sum_i ds q_i;  dv_j = sum_i p keep_P doh_i
//   dx = (dz1 + dq W_q^T + dk W_k^T + dv W_v^T) * valid
//   and every weight's gradient over the B * T rows:
//   W_{q,k,v} from (xm, dq|dk|dv), W_o from (oh, dy), W_1 from (x1 * valid
//   shifted by each tap, dc1), W_2 from (h shifted, dc2), R_k from (q,
//   band(ds)) and R_v from (doh, band(p keep_P)) summed over rows and heads
//   (the tables are shared), LN gains from (zhat, the LN output's cotangent),
//   the biases as column sums.
//
// What bounds it on an H100: operations, 3x the forward's: about 9.8 GFLOP
// over the valid rows and pairs at (8, 256), 0.15 ms at 67 TFLOP/s of fp32
// on the CUDA cores, 0.06 ms at 3 x 9.8 GFLOP over 495 TFLOP/s of TF32.
//
// Design. The TPU kernel holds one sequence per program in VMEM. Here the
// attention backward takes B2's design (attention_bwd.cu), 4 threads a row
// as in the forward, fp32 on the CUDA cores (a fifth of a call's time before
// the products moved: PERF.md): a dq kernel (grid (32-query tile, head,
// sequence)) that recomputes P from the saved (max, sum) with K and V
// streamed through shared memory, writes delta, and keeps each row's 2w + 1
// band values of ds and of the dropped P in registers (dq's R_k term, and
// the inputs of R_k's and R_v's gradients); and a dk/dv kernel (grid (32-key
// tile, head, sequence)) with q, doh, the rows' statistics and their band
// dots with R_k and R_v streamed through shared memory. No [T, T] tensor
// touches memory. Only valid (query, key) pairs are visited: the plain
// version's -1e4 fill gives them probability 0 in fp32. Every product runs
// on the tensor cores in 3xTF32 (conv_mma.cuh, each k-step's MMAs added in
// fp32): the recompute is the forward's chain (enc_layer_common.cuh) on the
// packed weights, one packing launch giving the forward's copies and the
// FFN convs' transposes (tap-flipped, read as shifted k-slices as the
// forward's taps are); the LayerNorm backwards are the epilogue of launches
// on 16-row tiles of the whole 192-channel row (LN2's with no product before
// it, LN1's after conv_k^T(dc1, W_1)); conv_k^T(dc2, W_2) with the relu's
// derivative and doh = dy W_o on 64-row tiles; dx in one product of depth
// 3C, dq|dk|dv against the packed [3C, C] weight, with dz1 added in the
// epilogue. The weight gradients are two fixed-order split-over-frames
// reductions: the products of one group a frame (W_q, W_k, W_v, W_o, each
// tap of W_1 and W_2, their biases) with the frames as the tensor cores'
// k (wgrad_mma.cuh), the head-grouped R_k and R_v and the LayerNorms'
// diagonal gains on the CUDA cores (wgrad_rows.cuh); no atomics, so two
// calls are bitwise equal. One call: a packing launch, 5 recompute
// launches, 5 products with epilogues, 2 attention kernels and 4 reduction
// launches (17).

#include <cuda_runtime.h>

#include <vector>

#include "enc_layer_common.cuh"
#include "wgrad_mma.cuh"
#include "wgrad_rows.cuh"

namespace enc_layer {
namespace {

struct LayerBwdTag {};

// the buffers, in ops/enc_layer.py:backward_buffer_shapes order
enum Buf : int { QKV, ATT, STATS, X1, ZHAT1, RINV1, HID, OUT, ZHAT2, RINV2, DZ2, GM, DC2, DC1, DZ1, DX1, DY, DATT,
                 DELTA, DCLOG, BANDP, DQKV, N_BUFS };
// the weights and their gradients, in ops/enc_layer.py:PARAM_NAMES order
enum Param : int { WQ, BQ, WK, BK, WV, BV, RK, RV, WO, BO, G1, BE1, W1, B1, W2, B2, G2, BE2, N_PARAMS };

__device__ __forceinline__ void load_part(float (&dst)[DP], const float* src) {
#pragma unroll
  for (int d = 0; d < DP; ++d) dst[d] = src[d];
}

template <class Tag>
__global__ void __launch_bounds__(ATT_THREADS) enc_attention_bwd_dq_kernel(
    const float* __restrict__ qkv, const float* __restrict__ att, const float* __restrict__ datt,
    const float2* __restrict__ stats, const float* __restrict__ rk, const float* __restrict__ rv,
    const int* __restrict__ lens, float* __restrict__ dqkv, float* __restrict__ delta,
    float* __restrict__ dclog, float* __restrict__ bandp, int T, int C, int window, float scale, Dropout drop) {
  __shared__ __align__(16) float ks[KT][HEAD_DIM];
  __shared__ __align__(16) float vs[KT][HEAD_DIM];
  const int tid = threadIdx.x, part = tid % PARTS, rl = tid / PARTS;
  const int h = blockIdx.y, H = gridDim.y, b = blockIdx.z;
  const int r = blockIdx.x * ROWS + rl, rr = min(r, T - 1);
  const int len = min(lens[b], T);
  const int ld = 3 * C, nrel = 2 * window + 1;
  const float* base = qkv + (size_t)b * T * ld;
  const int d0 = h * HEAD_DIM + part * DP;
  const size_t orow = ((size_t)b * T + rr) * C + d0;
  const uint32_t key = head_key(drop, b, h);
  const bool row_ok = r < len;

  float q[DP], dout[DP], dq[DP];
  load_part(q, base + (size_t)rr * ld + d0);
  load_part(dout, datt + orow);
#pragma unroll
  for (int d = 0; d < DP; ++d) dq[d] = 0.0f;
  // delta_i = doh_i . oh_i
  float dl = part_dot(dout, att + orow);
  const float2 st = stats[((size_t)b * H + h) * T + rr];
  const float m = st.x, inv_l = 1.0f / st.y;
  float qr[MAX_REL], dr[MAX_REL], dcl[MAX_REL], bp[MAX_REL];
#pragma unroll
  for (int i = 0; i < MAX_REL; ++i) {
    qr[i] = i < nrel ? part_dot(q, rk + i * HEAD_DIM + part * DP) : 0.0f;
    dr[i] = i < nrel ? part_dot(dout, rv + i * HEAD_DIM + part * DP) : 0.0f;
    dcl[i] = bp[i] = 0.0f;
  }

  const int c_end = blockIdx.x * ROWS < len ? len : 0;  // a tile of padded rows visits no key
  for (int c0 = 0; c0 < c_end; c0 += KT) {  // uniform in the block: every lane runs every key
    __syncthreads();
    for (int e = tid; e < KT * HEAD_DIM / 4; e += ATT_THREADS) {
      const int kr = e / (HEAD_DIM / 4), d = (e % (HEAD_DIM / 4)) * 4, c = c0 + kr;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (c < len) {
        kv = *reinterpret_cast<const float4*>(base + (size_t)c * ld + C + h * HEAD_DIM + d);
        vv = *reinterpret_cast<const float4*>(base + (size_t)c * ld + 2 * C + h * HEAD_DIM + d);
      }
      *reinterpret_cast<float4*>(&ks[kr][d]) = kv;
      *reinterpret_cast<float4*>(&vs[kr][d]) = vv;
    }
    __syncthreads();
    const int n = min(KT, len - c0);
    for (int j = 0; j < n; ++j) {
      const int c = c0 + j, off = c - rr;
      float rel = 0.0f, drel = 0.0f;
#pragma unroll
      for (int i = 0; i < MAX_REL; ++i) {
        const bool at = i < nrel && off == i - window;
        rel = at ? qr[i] : rel;
        drel = at ? dr[i] : drel;
      }
      const float s = (part_dot(q, &ks[j][part * DP]) + rel) * scale;
      const float p = expf(s - m) * inv_l;
      const float kf = keep_p(key, rr, c, T, drop);
      const float dp = (part_dot(dout, &vs[j][part * DP]) + drel) * kf;
      const float ds = p * (dp - dl) * scale;
      if (row_ok) {
#pragma unroll
        for (int d = 0; d < DP; ++d) dq[d] = fmaf(ds, ks[j][part * DP + d], dq[d]);
#pragma unroll
        for (int i = 0; i < MAX_REL; ++i) {
          const bool at = i < nrel && off == i - window;
          dcl[i] = at ? ds : dcl[i];
          bp[i] = at ? p * kf : bp[i];
        }
      }
    }
  }
  if (r >= T) return;
  if (row_ok)
    for (int i = 0; i < nrel; ++i)
#pragma unroll
      for (int d = 0; d < DP; ++d)
        dq[d] = fmaf(dcl[i], rk[i * HEAD_DIM + part * DP + d], dq[d]);
  float* dst = dqkv + ((size_t)b * T + r) * ld + d0;
#pragma unroll
  for (int d = 0; d < DP; ++d) dst[d] = row_ok ? dq[d] : 0.0f;
  if (part == 0) {
    delta[((size_t)b * H + h) * T + r] = row_ok ? dl : 0.0f;
    const size_t band = (((size_t)b * T + r) * H + h) * nrel;
#pragma unroll
    for (int i = 0; i < MAX_REL; ++i) {
      if (i < nrel) {
        dclog[band + i] = row_ok ? dcl[i] : 0.0f;
        bandp[band + i] = row_ok ? bp[i] : 0.0f;
      }
    }
  }
}

template <class Tag>
__global__ void __launch_bounds__(ATT_THREADS) enc_attention_bwd_dkdv_kernel(
    const float* __restrict__ qkv, const float* __restrict__ datt, const float2* __restrict__ stats,
    const float* __restrict__ delta, const float* __restrict__ rk, const float* __restrict__ rv,
    const int* __restrict__ lens, float* __restrict__ dqkv, int T, int C, int window, float scale, Dropout drop) {
  __shared__ __align__(16) float qs[KT][HEAD_DIM];
  __shared__ __align__(16) float gs[KT][HEAD_DIM];
  __shared__ float sm[KT], sl[KT], sd[KT];
  __shared__ float sqr[KT][MAX_REL], sdr[KT][MAX_REL];
  const int tid = threadIdx.x, part = tid % PARTS, rl = tid / PARTS;
  const int h = blockIdx.y, H = gridDim.y, b = blockIdx.z;
  const int c = blockIdx.x * ROWS + rl, cc = min(c, T - 1);
  const int len = min(lens[b], T);
  const int ld = 3 * C, nrel = 2 * window + 1;
  const float* base = qkv + (size_t)b * T * ld;
  const int d0 = h * HEAD_DIM + part * DP;
  const size_t stat0 = ((size_t)b * H + h) * T;
  const uint32_t key = head_key(drop, b, h);
  const bool col_ok = c < len;

  float kr[DP], vr[DP], dk[DP], dv[DP];
  load_part(kr, base + (size_t)cc * ld + C + d0);
  load_part(vr, base + (size_t)cc * ld + 2 * C + d0);
#pragma unroll
  for (int d = 0; d < DP; ++d) dk[d] = dv[d] = 0.0f;

  const int r_end = blockIdx.x * ROWS < len ? len : 0;  // a tile of padded keys visits no row
  for (int r0 = 0; r0 < r_end; r0 += KT) {  // uniform in the block
    __syncthreads();
    for (int e = tid; e < KT * HEAD_DIM / 4; e += ATT_THREADS) {
      const int i = e / (HEAD_DIM / 4), d = (e % (HEAD_DIM / 4)) * 4, r = r0 + i;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), gv = qv;
      if (r < len) {
        qv = *reinterpret_cast<const float4*>(base + (size_t)r * ld + h * HEAD_DIM + d);
        gv = *reinterpret_cast<const float4*>(datt + ((size_t)b * T + r) * C + h * HEAD_DIM + d);
      }
      *reinterpret_cast<float4*>(&qs[i][d]) = qv;
      *reinterpret_cast<float4*>(&gs[i][d]) = gv;
    }
    for (int i = tid; i < KT; i += ATT_THREADS) {
      const bool in = r0 + i < len;
      const float2 st = in ? stats[stat0 + r0 + i] : make_float2(0.f, 1.f);
      sm[i] = st.x;
      sl[i] = 1.0f / st.y;
      sd[i] = in ? delta[stat0 + r0 + i] : 0.f;
    }
    __syncthreads();
    // each row's band dots: q_i . R_k[o] and doh_i . R_v[o]
    for (int e = tid; e < KT * nrel; e += ATT_THREADS) {
      const int i = e / nrel, o = e % nrel;
      float a = 0.0f, g = 0.0f;
      for (int d = 0; d < HEAD_DIM; ++d) {
        a = fmaf(qs[i][d], rk[o * HEAD_DIM + d], a);
        g = fmaf(gs[i][d], rv[o * HEAD_DIM + d], g);
      }
      sqr[i][o] = a;
      sdr[i][o] = g;
    }
    __syncthreads();
    const int n = min(KT, len - r0);
    for (int i = 0; i < n; ++i) {
      const int r = r0 + i, o = cc - r + window;
      const bool band = o >= 0 && o < nrel;
      const float s = (part_dot(kr, &qs[i][part * DP]) + (band ? sqr[i][o] : 0.0f)) * scale;
      const float p = expf(s - sm[i]) * sl[i];
      const float kf = keep_p(key, r, cc, T, drop);
      const float dp = (part_dot(vr, &gs[i][part * DP]) + (band ? sdr[i][o] : 0.0f)) * kf;
      const float ds = p * (dp - sd[i]) * scale;
      if (col_ok) {
        const float pd = p * kf;
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          dv[d] = fmaf(pd, gs[i][part * DP + d], dv[d]);
          dk[d] = fmaf(ds, qs[i][part * DP + d], dk[d]);
        }
      }
    }
  }
  if (c >= T) return;
  float* dst = dqkv + ((size_t)b * T + c) * ld + d0;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    dst[C + d] = col_ok ? dk[d] : 0.0f;
    dst[2 * C + d] = col_ok ? dv[d] : 0.0f;
  }
}

// Every weight gradient as a reduction problem (pointers may be null when
// only the workspace's size is wanted): the tensor cores' (one group a
// frame), each list laid out with its slices, then the CUDA cores'
// (head-grouped, diagonal).
struct Problems {
  std::vector<wgrad_rows::Problem> mma, rows;
  int mma_split, rows_split;
  long long mma_floats, rows_floats;
};

Problems problems(const float* x, float* const* d, float* const* bufs, const Shape& sh) {
  using wgrad_rows::problem;
  const int C = sh.C, F = sh.F, k = sh.kernel_size, H = sh.n_heads, R = 2 * sh.window + 1;
  auto buf = [bufs](int i) -> float* { return bufs ? bufs[i] : nullptr; };
  auto grad = [d](int i) -> float* { return d ? d[i] : nullptr; };
  auto at = [](const float* p, size_t off) -> const float* { return p ? p + off : nullptr; };
  auto atg = [d](int i, size_t off) -> float* { return d ? d[i] + off : nullptr; };
  Problems f;
  for (int i = 0; i < 3; ++i) {  // q, k, v
    wgrad_rows::Problem p = problem(x, C, C, at(buf(DQKV), i * C), 3 * C, C, grad(WQ + 2 * i), C, 1);
    p.mask_x = 1;
    p.out_b = grad(BQ + 2 * i);
    f.mma.push_back(p);
  }
  wgrad_rows::Problem p = problem(buf(ATT), C, C, buf(DY), C, C, grad(WO), C, 1);
  p.out_b = grad(BO);
  f.mma.push_back(p);
  for (int j = 0; j < k; ++j) {
    p = problem(buf(X1), C, C, buf(DC1), F, F, atg(W1, j), C * k, k);
    p.shift = j - (k - 1) / 2;
    p.mask_x = 1;
    p.out_b = j == 0 ? grad(B1) : nullptr;
    f.mma.push_back(p);
    p = problem(buf(HID), F, F, buf(DC2), C, C, atg(W2, j), F * k, k);
    p.shift = j - (k - 1) / 2;
    p.out_b = j == 0 ? grad(B2) : nullptr;
    f.mma.push_back(p);
  }
  const long long tiles = wgrad_mma::assign_tiles(f.mma);
  f.mma_split = wgrad_mma::splits<LayerBwdTag>(tiles, (long long)sh.B * sh.T);
  f.mma_floats = tiles * f.mma_split * wgrad_mma::PART;
  p = problem(buf(QKV), 3 * C, HEAD_DIM, buf(DCLOG), H * R, R, grad(RK), HEAD_DIM, 1);
  p.groups = H; p.gx = HEAD_DIM; p.gy = R;
  f.rows.push_back(p);
  p = problem(buf(DATT), C, HEAD_DIM, buf(BANDP), H * R, R, grad(RV), HEAD_DIM, 1);
  p.groups = H; p.gx = HEAD_DIM; p.gy = R;
  f.rows.push_back(p);
  p = problem(buf(ZHAT1), C, C, buf(DX1), C, C, grad(G1), 1, 0);
  p.diag = 1;
  p.out_b = grad(BE1);
  f.rows.push_back(p);
  p = problem(buf(ZHAT2), C, C, buf(GM), C, C, grad(G2), 1, 0);
  p.diag = 1;
  p.out_b = grad(BE2);
  f.rows.push_back(p);
  // four light problems of 2-3 tiles each: slices of 64 frames (at most 64) spread them over the card
  const long long frames = (long long)sh.B * sh.T;
  f.rows_split = (int)((frames + 63) / 64 < 64 ? (frames + 63) / 64 : 64);
  f.rows_floats = wgrad_rows::assign_partials(f.rows, f.rows_split);
  return f;
}

}  // namespace
}  // namespace enc_layer

// Floats of the workspace enc_layer_bwd needs: the packed weights, then the
// two reductions' partials (-1 for a shape the kernels do not take).
extern "C" long enc_layer_bwd_workspace_floats(int B, int T, int C, int n_heads, int window, int F,
                                               int kernel_size) {
  using namespace enc_layer;
  const Shape sh{B, T, C, n_heads, window, F, kernel_size, 0.0f};
  if (!valid_shape(sh)) return -1;
  const Problems f = problems(nullptr, nullptr, nullptr, sh);
  if (f.mma_split < 1) return -1;
  return (long)(packed_floats(sh, true) + f.mma_floats + f.rows_floats);
}

namespace enc_layer {
namespace {

// The backward's launches.
int backward(const float* x, const int* lens, const long long* seed, const float* g, const float* const* params,
             float* dx, float* const* grads, float* const* bufs, float* workspace, const Shape& sh, unsigned threshold,
             float keep_scale, cudaStream_t s) {
  using namespace conv_rows;
  using Tag = LayerBwdTag;
  const int B = sh.B, T = sh.T, C = sh.C, kernel_size = sh.kernel_size, n_heads = sh.n_heads, window = sh.window;
  const float* const* p = params;
  const Weights w{p[WQ], p[BQ], p[WK], p[BK], p[WV], p[BV], p[RK], p[RV], p[WO], p[BO], p[G1], p[BE1],
                  p[W1], p[B1], p[W2], p[B2], p[G2], p[BE2]};
  const Dropout drop{seed, threshold, keep_scale};
  float2* stats = reinterpret_cast<float2*>(bufs[STATS]);
  Packed pk;
  cudaError_t err = pack<Tag>(w, sh, true, workspace, &pk, s);
  if (err != cudaSuccess) return (int)err;
  err = forward_chain<Tag>(x, lens, w, pk, sh, drop, bufs[OUT], bufs[QKV], bufs[ATT], stats, bufs[X1],
                               bufs[ZHAT1], bufs[RINV1], bufs[HID], bufs[ZHAT2], bufs[RINV2], s);
  if (err != cudaSuccess) return (int)err;

  // the transposed products read their weights transposed: 1x1 ones as [cin][n_out]
  // rows (wt), the FFN convs' from the packed tap-flipped copies
  Args a{};
  a.lens = lens; a.T = T; a.dil = 1; a.wt = 1;
  a.seed = seed; a.threshold = threshold; a.keep_scale = keep_scale; a.stream_mul = ENC_STREAMS;

  Args l2 = a;  // LN2's backward alone: dz2, g masked, dc2 = dz2 * keep_F * valid
  l2.cin = 0; l2.n_out = C; l2.out = bufs[DZ2]; l2.ldo = C;
  l2.res = g; l2.ldr = C; l2.mask_res = 1; l2.mask_acc = 0;
  l2.zhat = bufs[ZHAT2]; l2.rinv = bufs[RINV2]; l2.ldz = C; l2.gamma = w.g2;
  l2.out2 = bufs[GM]; l2.out3 = bufs[DC2];
  l2.stream_add = SITE_FFN_Y * 16; l2.drop_ld = C;
  err = product<Tag, 1, LN_TN, LN_BWD>(l2, B, s);
  if (err != cudaSuccess) return (int)err;

  Args f2 = a;  // dc1 = conv^T(dc2, W_2) where the relu kept the row (h > 0), times the keep scale
  f2.in = bufs[DC2]; f2.ldi = C; f2.cin = C; f2.mask_in = 1;
  f2.w = pk.w2t; f2.n_out = sh.F; f2.out = bufs[DC1]; f2.ldo = sh.F; f2.res = bufs[HID]; f2.ldr = sh.F;
  err = product_taps<Tag, 128, DRELU>(kernel_size, f2, B, s);
  if (err != cudaSuccess) return (int)err;

  Args f1 = a;  // dx1 = dz2 + conv^T(dc1, W_1) * valid, then LN1's backward; dy = dz1 * keep_Y * valid
  f1.in = bufs[DC1]; f1.ldi = sh.F; f1.cin = sh.F; f1.mask_in = 1;
  f1.w = pk.w1t; f1.n_out = C; f1.out = bufs[DZ1]; f1.ldo = C;
  f1.res = bufs[DZ2]; f1.ldr = C; f1.mask_res = 0; f1.mask_acc = 1;
  f1.zhat = bufs[ZHAT1]; f1.rinv = bufs[RINV1]; f1.ldz = C; f1.gamma = w.g1;
  f1.out2 = bufs[DX1]; f1.out3 = bufs[DY];
  f1.stream_add = SITE_ATTN_Y * 16; f1.drop_ld = C;
  err = product_taps<Tag, LN_TN, LN_BWD>(kernel_size, f1, B, s);
  if (err != cudaSuccess) return (int)err;

  Args o = a;  // doh = dy W_o^T
  o.in = bufs[DY]; o.ldi = C; o.cin = C; o.mask_in = 0;
  o.w = w.wo; o.n_out = C; o.out = bufs[DATT]; o.ldo = C;
  err = product<Tag, 1, 64, BIAS>(o, B, s);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((T + ROWS - 1) / ROWS, n_heads, B);
  const float scale = 1.0f / sqrtf((float)HEAD_DIM);
  enc_attention_bwd_dq_kernel<Tag><<<grid, ATT_THREADS, 0, s>>>(
      bufs[QKV], bufs[ATT], bufs[DATT], stats, w.rk, w.rv, lens, bufs[DQKV], bufs[DELTA], bufs[DCLOG],
      bufs[BANDP], T, C, window, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // same stream: this kernel reads the delta the dq kernel wrote
  enc_attention_bwd_dkdv_kernel<Tag><<<grid, ATT_THREADS, 0, s>>>(
      bufs[QKV], bufs[DATT], stats, bufs[DELTA], w.rk, w.rv, lens, bufs[DQKV], T, C, window, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Args t = a;  // dx = (dz1 + [dq|dk|dv] [W_q; W_k; W_v]) * valid: one product of depth 3C
  t.in = bufs[DQKV]; t.ldi = 3 * C; t.cin = 3 * C; t.mask_in = 0;
  t.w = pk.wqkv; t.n_out = C; t.out = dx; t.ldo = C;
  t.res = bufs[DZ1]; t.ldr = C; t.hidden = 0;
  err = product<Tag, 1, LN_TN, RES_SKIP>(t, B, s);
  if (err != cudaSuccess) return (int)err;

  const Problems f = problems(x, grads, bufs, sh);
  if (f.mma_split < 1) return (int)cudaErrorInvalidValue;
  float* partials = workspace + packed_floats(sh, true);
  err = wgrad_mma::run<Tag>(f.mma, lens, B, T, f.mma_split, partials, s);
  if (err != cudaSuccess) return (int)err;
  return (int)wgrad_rows::run<Tag>(f.rows, lens, B, T, f.rows_split, partials + f.mma_floats, s);
}

}  // namespace
}  // namespace enc_layer

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// x, lens, seed and the 18 weights (`params`, PARAM_NAMES order) as for
// enc_layer_fwd; g [B, T, C] contiguous; outputs dx [B, T, C] and the 18
// gradients (`grads`, the weights' layouts); `bufs` the 22 device buffers of
// ops/enc_layer.py:backward_buffer_shapes and `workspace`
// (enc_layer_bwd_workspace_floats).
extern "C" int enc_layer_bwd(const float* x, const int* lens, const long long* seed, const float* g,
                             const float* const* params, float* dx, float* const* grads, float* const* bufs,
                             float* workspace, int B, int T, int C, int n_heads, int window, int F,
                             int kernel_size, float eps, unsigned threshold, float keep_scale, void* stream) {
  const enc_layer::Shape sh{B, T, C, n_heads, window, F, kernel_size, eps};
  if (!enc_layer::valid_shape(sh)) return (int)cudaErrorInvalidValue;
  return enc_layer::backward(x, lens, seed, g, params, dx, grads, bufs, workspace, sh, threshold, keep_scale,
                             static_cast<cudaStream_t>(stream));
}

// The tensor-core kernels' resident blocks per SM and dynamic shared memory
// bytes at their launches: the 16-row LayerNorm tile of 192 columns (FFN
// conv 2 + LN1's backward, k = 3), the 64 x 128 FFN conv (the transposed
// one, k = 3), the 64 x 64 1x1 product, the weight-gradient slices. Returns
// a cudaError_t.
extern "C" int enc_layer_bwd_blocks_per_sm(int* blocks, long long* smem) {
  using namespace conv_rows;
  using enc_layer::LayerBwdTag;
  const void* kernels[4] = {
      (const void*)conv_mma::conv_mma_kernel<LayerBwdTag, 3, enc_layer::LN_TN, LN_BWD, true, 16, 3>,
      (const void*)conv_mma::conv_mma_kernel<LayerBwdTag, 3, 128, DRELU, true>,
      (const void*)conv_mma::conv_mma_kernel<LayerBwdTag, 1, 64, BIAS, true>,
      (const void*)wgrad_mma::wgrad_mma_kernel<LayerBwdTag, true>};
  const size_t bytes[4] = {conv_mma::Tile<enc_layer::LN_TN, 16, 3>::SMEM, conv_mma::Tile<128>::SMEM,
                           conv_mma::Tile<64>::SMEM, wgrad_mma::SMEM};
  for (int i = 0; i < 4; ++i) {
    blocks[i] = conv_mma::blocks_per_sm(kernels[i], bytes[i]);
    smem[i] = (long long)bytes[i];
  }
  return (int)cudaGetLastError();
}
