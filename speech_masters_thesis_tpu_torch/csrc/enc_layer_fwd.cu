// One Glow-TTS text-encoder layer forward for Hopper (sm_90a), fp32.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/enc_layer.py, function
// fused_enc_layer -> pallas_call(_fwd_kernel) (body _layer_fwd_body), for
// the windowed, bidirectional text-encoder layer. The recompute backward
// (its _vjp_bwd) is not ported yet. Plain version:
// ops/enc_layer.py:enc_layer_reference.
//
// What it computes for x [B, T, C] with 2 heads of D = C / 2, window w:
//   xm = x * valid;  q, k, v = xm W_{q,k,v} + b
//   per head: s[i, j] = (q_i . k_j + [|j - i| <= w] q_i . R_k[j - i + w]) / sqrt(D),
//             -1e4 where i or j >= len (not -inf), p = softmax_j(s),
//             o_i = sum_j p[i, j] v_j + sum_{|j - i| <= w} p[i, j] R_v[j - i + w]
//   x1  = LN1(xm + o W_o + b_o)
//   f   = conv_k(relu(conv_k(x1 * valid, W_1) + b_1) * valid, W_2) + b_2
//   out = LN2(x1 + f * valid)
// with valid = t < lens[b] and flax's LayerNorm (var = E[z^2] - E[z]^2,
// eps 1e-4). Rows at or past len give finite values that every consumer
// masks; the TPU kernel's softmax there is uniform over its padded width and
// this one's over T, so the two agree at valid rows only.
//
// What bounds it on an H100: operations. Per token the products cost about
// 2.06 MFLOP (QKV and W_o 4 x 2C^2, the two k=3 FFN convs 4 k C F) plus
// 4 T D per head for attention, against 1.5 KB of input and output: at
// (8, 256) about 4.6 GFLOP, 0.07 ms at 67 TFLOP/s.
//
// Design. One head's [T, T] scores are 1 MB at T=512, more than a block's
// 227 KB, so attention reuses B2's design (attention_fwd.cu): grid (64-row
// query tile, head, sequence), K and V streamed through shared memory in
// 32-key tiles, an online softmax per 16-key chunk. With D = 96 a row is
// shared by 4 threads (24 dimensions each, partial dots summed with two
// shuffles), so q and o stay in registers. The relative-key term adds
// q_i . R_k[o] (nine dots per row, computed once) inside the band. The
// relative-value term needs the band's probabilities under the final max
// and sum: after the loop each row recomputes its 2w + 1 band scores from
// K, divides by the sum and adds them times R_v. The products around
// attention (QKV, W_o with the residual and LN1, the FFN's two k=3 convs
// with LN2) are launches of the row-tiled convolution of conv_rows.cuh;
// the k=3 convs take their one-row halo from the neighbouring tile's rows,
// since x1 and the FFN's hidden rows go through device memory. One layer is
// 7 launches: q, k, v, attention, W_o + LN1, FFN conv 1, FFN conv 2 + LN2.

#include <cuda_runtime.h>

#include "conv_rows.cuh"

namespace {

struct EncTag {};

constexpr int HEAD_DIM = 96;     // ops/_build.py ENC_HEAD_DIM
constexpr int MAX_WINDOW = 8;    // ops/_build.py ENC_MAX_WINDOW
constexpr int PARTS = 4;         // threads per query row
constexpr int DP = HEAD_DIM / PARTS;
constexpr int ROWS = 64;         // query rows per block
constexpr int ATT_THREADS = ROWS * PARTS;
constexpr int KT = 32;           // keys per shared-memory tile
constexpr int CHUNK = 16;        // keys per softmax update
constexpr float NEG_MASK = -1e4f;

__device__ __forceinline__ float part_dot(const float (&q)[DP], const float* row) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(row + d);
    s = fmaf(q[d], k4.x, s);
    s = fmaf(q[d + 1], k4.y, s);
    s = fmaf(q[d + 2], k4.z, s);
    s = fmaf(q[d + 3], k4.w, s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// qkv: [B, T, 3C] (q | k | v, head h at columns h * D); att: [B, T, C].
__global__ void __launch_bounds__(ATT_THREADS) enc_attention_kernel(const float* __restrict__ qkv,
                                                           const float* __restrict__ rk,
                                                           const float* __restrict__ rv,
                                                           const int* __restrict__ lens,
                                                           float* __restrict__ att, int T, int C,
                                                           int window, float scale) {
  __shared__ __align__(16) float ks[KT][HEAD_DIM];
  __shared__ __align__(16) float vs[KT][HEAD_DIM];
  const int tid = threadIdx.x, part = tid % PARTS, rl = tid / PARTS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r = blockIdx.x * ROWS + rl;
  const int rr = min(r, T - 1);
  const int len = lens[b];
  const int ld = 3 * C;
  const float* base = qkv + (size_t)b * T * ld;
  const int d0 = h * HEAD_DIM + part * DP;

  float q[DP], o[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    q[d] = base[(size_t)rr * ld + d0 + d];
    o[d] = 0.0f;
  }
  const int nrel = 2 * window + 1;
  float qr[2 * MAX_WINDOW + 1];
#pragma unroll
  for (int i = 0; i < 2 * MAX_WINDOW + 1; ++i) qr[i] = i < nrel ? part_dot(q, rk + i * HEAD_DIM + part * DP) : 0.0f;

  const bool row_ok = r < len;
  float m = -INFINITY, l = 0.0f;
  for (int c0 = 0; c0 < T; c0 += KT) {
    __syncthreads();
    for (int e = tid; e < KT * HEAD_DIM / 4; e += ATT_THREADS) {
      const int kr = e / (HEAD_DIM / 4), d = (e % (HEAD_DIM / 4)) * 4, c = c0 + kr;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (c < T) {
        kv = *reinterpret_cast<const float4*>(base + (size_t)c * ld + C + h * HEAD_DIM + d);
        vv = *reinterpret_cast<const float4*>(base + (size_t)c * ld + 2 * C + h * HEAD_DIM + d);
      }
      *reinterpret_cast<float4*>(&ks[kr][d]) = kv;
      *reinterpret_cast<float4*>(&vs[kr][d]) = vv;
    }
    __syncthreads();
    const int n = min(KT, T - c0);
    for (int k0 = 0; k0 < n; k0 += CHUNK) {
      float s[CHUNK];
      float mc = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < CHUNK; ++kk) {
        const int c = c0 + k0 + kk;
        float sc = part_dot(q, &ks[k0 + kk][part * DP]);
        const int off = c - rr;
        float rel = 0.0f;
#pragma unroll
        for (int i = 0; i < 2 * MAX_WINDOW + 1; ++i) rel = (i < nrel && off == i - window) ? qr[i] : rel;
        sc = (sc + rel) * scale;
        sc = (row_ok && c < len) ? sc : NEG_MASK;
        s[kk] = k0 + kk < n ? sc : -INFINITY;
        mc = fmaxf(mc, s[kk]);
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DP; ++d) o[d] *= alpha;
#pragma unroll
      for (int kk = 0; kk < CHUNK; ++kk) {
        const float p = expf(s[kk] - m_new);
        l += p;
        const float* vrow = &vs[k0 + kk][part * DP];
#pragma unroll
        for (int d = 0; d < DP; ++d) o[d] = fmaf(p, vrow[d], o[d]);
      }
      m = m_new;
    }
  }

  // the relative-value term: the band's probabilities under the final (m, l)
  const float inv_l = 1.0f / l;
#pragma unroll
  for (int d = 0; d < DP; ++d) o[d] *= inv_l;
  for (int i = 0; i < nrel; ++i) {  // every lane runs every step: part_dot shuffles
    const int c = rr + i - window;
    const int cc = min(max(c, 0), T - 1);
    float sc = (part_dot(q, base + (size_t)cc * ld + C + h * HEAD_DIM + part * DP) + qr[i]) * scale;
    sc = (row_ok && c < len) ? sc : NEG_MASK;
    const float p = (c >= 0 && c < T) ? expf(sc - m) * inv_l : 0.0f;
    const float* rvrow = rv + i * HEAD_DIM + part * DP;
#pragma unroll
    for (int d = 0; d < DP; ++d) o[d] = fmaf(p, rvrow[d], o[d]);
  }
  if (r < T) {
    float* dst = att + ((size_t)b * T + r) * C + d0;
#pragma unroll
    for (int d = 0; d < DP; ++d) dst[d] = o[d];
  }
}

}  // namespace

extern "C" int enc_layer_fwd(const float* x, const int* lens, const float* wq, const float* bq,
                             const float* wk, const float* bk, const float* wv, const float* bv,
                             const float* rk, const float* rv, const float* wo, const float* bo,
                             const float* g1, const float* be1, const float* w1, const float* b1,
                             const float* w2, const float* b2, const float* g2, const float* be2,
                             float* out, float* qkv, float* att, float* x1, float* hid, int B, int T,
                             int C, int n_heads, int window, int F, int kernel_size, float eps,
                             void* stream) {
  using namespace conv_rows;
  if (B < 1 || T < 1 || C != 192 || C != n_heads * HEAD_DIM || window < 0 || window > MAX_WINDOW ||
      (kernel_size != 1 && kernel_size != 3 && kernel_size != 5))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{};
  a.lens = lens;
  a.T = T;
  a.dil = 1;
  a.eps = eps;

  const float* w3[3] = {wq, wk, wv};
  const float* b3[3] = {bq, bk, bv};
  for (int i = 0; i < 3; ++i) {
    Args p = a;
    p.in = x; p.ldi = C; p.cin = C; p.mask_in = 1;
    p.w = w3[i]; p.bias = b3[i]; p.n_out = C; p.out = qkv + i * C; p.ldo = 3 * C;
    cudaError_t err = launch<EncTag, 1, 32, 64, BIAS>(p, B, s);
    if (err != cudaSuccess) return (int)err;
  }

  const dim3 grid((T + ROWS - 1) / ROWS, n_heads, B);
  enc_attention_kernel<<<grid, ATT_THREADS, 0, s>>>(qkv, rk, rv, lens, att, T, C, window,
                                           1.0f / sqrtf((float)HEAD_DIM));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Args o = a;
  o.in = att; o.ldi = C; o.cin = C; o.mask_in = 0;
  o.w = wo; o.bias = bo; o.n_out = C; o.out = x1; o.ldo = C;
  o.res = x; o.ldr = C; o.mask_res = 1; o.mask_acc = 0; o.gamma = g1; o.beta = be1;
  err = launch<EncTag, 1, 16, 192, LN>(o, B, s);
  if (err != cudaSuccess) return (int)err;

  Args f1 = a;
  f1.in = x1; f1.ldi = C; f1.cin = C; f1.mask_in = 1;
  f1.w = w1; f1.bias = b1; f1.n_out = F; f1.out = hid; f1.ldo = F;
  err = launch_taps<EncTag, 32, 64, RELU_MASK>(kernel_size, f1, B, s);
  if (err != cudaSuccess) return (int)err;

  Args f2 = a;
  f2.in = hid; f2.ldi = F; f2.cin = F; f2.mask_in = 1;
  f2.w = w2; f2.bias = b2; f2.n_out = C; f2.out = out; f2.ldo = C;
  f2.res = x1; f2.ldr = C; f2.mask_res = 0; f2.mask_acc = 1; f2.gamma = g2; f2.beta = be2;
  return (int)launch_taps<EncTag, 16, 192, LN>(kernel_size, f2, B, s);
}
