// One Glow-TTS text-encoder layer's forward, shared by the forward kernel
// (enc_layer_fwd.cu) and the fp32 backward's recompute (enc_layer_bwd.cu):
// the windowed relative attention kernel, the packing of the weights the
// products read, and the chain of launches around them. The products run on
// the tensor cores in 3xTF32 (conv_mma.cuh), with conv_rows.cuh's epilogues.
// fp32 only: the bf16 mode's forward and backward (enc_layer_bf16.cu) run
// the TMA + wgmma engine of bf16_engine.cuh.
//
// Dropout (threshold 0: none; ops/enc_layer.py computes the same bits): the
// attention probabilities of head h draw from stream b * ENC_STREAMS +
// SITE_ATTN_P * 16 + h at counter query * T + key; the row sites (conv_o's
// output, the FFN's hidden rows after relu, the FFN's output) from stream
// b * ENC_STREAMS + site * 16 at counter t * width + c.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "conv_mma.cuh"
#include "conv_rows.cuh"

namespace enc_layer {

constexpr int HEAD_DIM = 96;     // ops/_build.py ENC_HEAD_DIM
constexpr int MAX_WINDOW = 8;    // ops/_build.py ENC_MAX_WINDOW
constexpr int MAX_REL = 2 * MAX_WINDOW + 1;
constexpr int PARTS = 4;         // threads per query (or key) row
constexpr int DP = HEAD_DIM / PARTS;
constexpr int ROWS = 32;         // query (or key) rows per block: 128 blocks at (8, 256), not 64 (PERF.md)
constexpr int ATT_THREADS = ROWS * PARTS;
constexpr int KT = 32;           // rows per shared-memory tile
constexpr int CHUNK = 16;        // keys per softmax update
constexpr float NEG_MASK = -1e4f;
constexpr int ENC_STREAMS = 64;  // ops/enc_layer.py ENC_STREAMS
constexpr int SITE_ATTN_P = 0, SITE_ATTN_Y = 1, SITE_FFN_MID = 2, SITE_FFN_Y = 3;

struct Weights {
  const float *wq, *bq, *wk, *bk, *wv, *bv, *rk, *rv, *wo, *bo, *g1, *be1, *w1, *b1, *w2, *b2, *g2, *be2;
};

struct Shape {
  int B, T, C, n_heads, window, F, kernel_size;
  float eps;
};

// What the products read in place of some weights (pack): W_q, W_k and W_v
// as one [3C, C] weight and their biases as one [3C]; for k > 1 the FFN's
// convs tap-major, W_1 as [k][C][F] and W_2 as [k][F][C] (the conv's
// form), and for the backward their transposes tap-flipped, W_2's as
// [k][C][F] and W_1's as [k][F][C]. For k = 1 the FFN's weights are read
// as they are (w1t, w2t too: the backward's launches read them transposed).
struct Packed {
  const float *wqkv, *bqkv, *w1, *w2, *w1t, *w2t;
};

struct Dropout {
  const long long* seed;
  unsigned threshold;
  float keep_scale;
};

inline bool valid_shape(const Shape& s) {
  return s.B >= 1 && s.B <= 65535 && s.T >= 1 && s.C == 192 && s.C == s.n_heads * HEAD_DIM && s.window >= 0 &&
         s.window <= MAX_WINDOW && s.F >= 1 && (s.kernel_size == 1 || s.kernel_size == 3 || s.kernel_size == 5);
}

// Floats of the packed weights (the forward's, or with `backward` the
// transposes too).
inline size_t packed_floats(const Shape& s, bool backward) {
  const size_t C = s.C, F = s.F, k = s.kernel_size;
  return 3 * C * C + 3 * C + (k > 1 ? (backward ? 4 : 2) * k * C * F : 0);
}

// One copy of the packing launch: src [n_out, cin, taps] (PyTorch's Conv1d
// layout) into dst as [taps][cin][n_out] (form 0: the conv) or
// [taps][n_out][cin] tap-flipped (form 1: its transpose; with one tap and
// one output a plain copy), as conv_mma::pack_weights_kernel's forms.
struct PackJob {
  const float* src;
  float* dst;
  int n_out, cin, taps, form;
};

constexpr int MAX_PACK_JOBS = 10;

struct PackJobs {
  PackJob job[MAX_PACK_JOBS];
  int n;
};

template <class Tag>
__global__ void __launch_bounds__(conv_mma::NT) enc_pack_kernel(const PackJobs p) {
  const PackJob& j = p.job[blockIdx.y];
  const float* src = j.src;
  float* dst = j.dst;
  const int size = j.taps * j.n_out * j.cin;
  for (int e = blockIdx.x * conv_mma::NT + threadIdx.x; e < size; e += gridDim.x * conv_mma::NT) {
    int tap, c, n, v;
    if (j.form == 0) {  // dst[tap][c][n] = src[n][c][tap], c < cin, n < n_out
      tap = e / (j.cin * j.n_out);
      c = e / j.n_out % j.cin;
      n = e % j.n_out;
      v = (n * j.cin + c) * j.taps + tap;
    } else {  // dst[tap][c][n] = src[c][n][taps - 1 - tap], c < n_out, n < cin
      tap = e / (j.n_out * j.cin);
      c = e / j.cin % j.n_out;
      n = e % j.cin;
      v = (c * j.cin + n) * j.taps + (j.taps - 1 - tap);
    }
    dst[e] = src[v];
  }
}

// The packed weights into `ws` (packed_floats(sh, backward)) in one launch.
template <class Tag>
cudaError_t pack(const Weights& w, const Shape& sh, bool backward, float* ws, Packed* pk, cudaStream_t s) {
  const int C = sh.C, F = sh.F, k = sh.kernel_size;
  PackJobs p{};
  auto add = [&p](const float* src, float* dst, int n_out, int cin, int taps, int form) {
    p.job[p.n++] = PackJob{src, dst, n_out, cin, taps, form};
  };
  auto at = [](float* base, size_t elems) { return base + elems; };
  float* wqkv = ws;
  float* bqkv = at(wqkv, (size_t)3 * C * C);
  const float* w3[3] = {w.wq, w.wk, w.wv};
  const float* b3[3] = {w.bq, w.bk, w.bv};
  for (int i = 0; i < 3; ++i) {
    add(w3[i], at(wqkv, (size_t)i * C * C), C, C, 1, 1);
    add(b3[i], at(bqkv, (size_t)i * C), 1, C, 1, 1);
  }
  *pk = Packed{wqkv, bqkv, w.w1, w.w2, w.w1, w.w2};
  if (k > 1) {
    const size_t size = (size_t)k * C * F;
    float* f = at(bqkv, 3 * C);
    add(w.w1, f, F, C, k, 0);
    add(w.w2, at(f, size), C, F, k, 0);
    pk->w1 = f;
    pk->w2 = at(f, size);
    if (backward) {
      add(w.w2, at(f, 2 * size), C, F, k, 1);
      add(w.w1, at(f, 3 * size), F, C, k, 1);
      pk->w2t = at(f, 2 * size);
      pk->w1t = at(f, 3 * size);
    }
  }
  int most = 0;
  for (int i = 0; i < p.n; ++i) {
    const int size = p.job[i].taps * p.job[i].n_out * p.job[i].cin;
    most = size > most ? size : most;
  }
  const dim3 grid((most + 4 * conv_mma::NT - 1) / (4 * conv_mma::NT), p.n);
  enc_pack_kernel<Tag><<<grid, conv_mma::NT, 0, s>>>(p);
  return cudaGetLastError();
}

// A product of the chain on conv_mma.cuh: 64-row tiles of TN = 64 or 128
// columns, or with TN = LN_TN tiles of 16 rows by the whole 192-channel row
// (warps of 16 x 24), which the LayerNorm epilogues need (and which gives
// 2,048 rows 128 blocks, about one wave of the card).
constexpr int LN_TN = 192;

template <class Tag, int TAPS, int TN, int EPI>
cudaError_t product(const conv_rows::Args& a, int B, cudaStream_t s) {
  return conv_mma::launch<Tag, TAPS, TN, EPI, TN == LN_TN ? 16 : 64, TN == LN_TN ? 3 : 4>(a, B, s);
}

// The same with the number of taps chosen at run time (1, 3 or 5).
template <class Tag, int TN, int EPI>
cudaError_t product_taps(int taps, const conv_rows::Args& a, int B, cudaStream_t s) {
  switch (taps) {
    case 1: return product<Tag, 1, TN, EPI>(a, B, s);
    case 3: return product<Tag, 3, TN, EPI>(a, B, s);
    case 5: return product<Tag, 5, TN, EPI>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// the dropout factor of (query r, key c) of one head's probabilities
__device__ __forceinline__ float keep_p(uint32_t key, int r, int c, int T, const Dropout& d) {
  if (!d.threshold) return 1.0f;
  return hash_draw(key, (uint32_t)r * (uint32_t)T + (uint32_t)c) >= d.threshold ? d.keep_scale : 0.0f;
}

__device__ __forceinline__ uint32_t head_key(const Dropout& d, int b, int h) {
  return d.threshold ? stream_key((uint32_t)d.seed[0], (uint32_t)(b * ENC_STREAMS + SITE_ATTN_P * 16 + h)) : 0u;
}

// a row's DP-slice dot with 16-byte aligned `row`, summed over the row's 4 lanes
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

// qkv: [B, T, 3C] (q | k | v, head h at columns h * D); att: [B, T, C];
// stats (when set): [B, heads, T] of (max, sum) of each row's softmax.
template <class Tag>
__global__ void __launch_bounds__(ATT_THREADS) enc_attention_kernel(const float* __restrict__ qkv,
                                                                const float* __restrict__ rk,
                                                                const float* __restrict__ rv,
                                                                const int* __restrict__ lens,
                                                                float* __restrict__ att, float2* __restrict__ stats,
                                                                int T, int C, int window, float scale, Dropout drop) {
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
  const uint32_t key = head_key(drop, b, h);

  float q[DP], o[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    q[d] = base[(size_t)rr * ld + d0 + d];
    o[d] = 0.0f;
  }
  const int nrel = 2 * window + 1;
  float qr[MAX_REL];
#pragma unroll
  for (int i = 0; i < MAX_REL; ++i) qr[i] = i < nrel ? part_dot(q, rk + i * HEAD_DIM + part * DP) : 0.0f;

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
        for (int i = 0; i < MAX_REL; ++i) rel = (i < nrel && off == i - window) ? qr[i] : rel;
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
        const float pd = k0 + kk < n ? p * keep_p(key, rr, c0 + k0 + kk, T, drop) : 0.0f;
        const float* vrow = &vs[k0 + kk][part * DP];
#pragma unroll
        for (int d = 0; d < DP; ++d) o[d] = fmaf(pd, vrow[d], o[d]);
      }
      m = m_new;
    }
  }

  // the relative-value term: the band's (dropped) probabilities under the final (m, l)
  const float inv_l = 1.0f / l;
#pragma unroll
  for (int d = 0; d < DP; ++d) o[d] *= inv_l;
  for (int i = 0; i < nrel; ++i) {  // every lane runs every step: part_dot shuffles
    const int c = rr + i - window;
    const int cc = min(max(c, 0), T - 1);
    float sc = (part_dot(q, base + (size_t)cc * ld + C + h * HEAD_DIM + part * DP) + qr[i]) * scale;
    sc = (row_ok && c < len) ? sc : NEG_MASK;
    const float p = (c >= 0 && c < T) ? expf(sc - m) * inv_l * keep_p(key, rr, cc, T, drop) : 0.0f;
    const float* rvrow = rv + i * HEAD_DIM + part * DP;
#pragma unroll
    for (int d = 0; d < DP; ++d) o[d] = fmaf(p, rvrow[d], o[d]);
  }
  if (r < T) {
    float* dst = att + ((size_t)b * T + r) * C + d0;
#pragma unroll
    for (int d = 0; d < DP; ++d) dst[d] = o[d];
    if (stats && part == 0) stats[((size_t)b * gridDim.y + h) * T + r] = make_float2(m, l);
  }
}

// The layer's forward launches on the packed weights `pk` (pack): q|k|v
// in one product, attention, W_o + LN1, FFN conv 1, FFN conv 2 + LN2. The
// recompute's extra outputs (stats, zhat1, rinv1, zhat2, rinv2) are
// written when set.
template <class Tag>
cudaError_t forward_chain(const float* x, const int* lens, const Weights& w, const Packed& pk, const Shape& sh,
                          const Dropout& drop, float* out, float* qkv, float* att, float2* stats, float* x1,
                          float* zhat1, float* rinv1, float* hid, float* zhat2, float* rinv2, cudaStream_t s) {
  using namespace conv_rows;
  const int B = sh.B, T = sh.T, C = sh.C, F = sh.F;
  Args a{};
  a.lens = lens;
  a.T = T;
  a.dil = 1;
  a.eps = sh.eps;
  a.seed = drop.seed; a.threshold = drop.threshold; a.keep_scale = drop.keep_scale;
  a.stream_mul = ENC_STREAMS;

  Args p = a;
  p.in = x; p.ldi = C; p.cin = C; p.mask_in = 1;
  p.w = pk.wqkv; p.bias = pk.bqkv; p.n_out = 3 * C; p.out = qkv; p.ldo = 3 * C;
  cudaError_t err = product<Tag, 1, 64, BIAS>(p, B, s);
  if (err != cudaSuccess) return err;

  const dim3 grid((T + ROWS - 1) / ROWS, sh.n_heads, B);
  enc_attention_kernel<Tag><<<grid, ATT_THREADS, 0, s>>>(qkv, w.rk, w.rv, lens, att, stats, T, C, sh.window,
                                                         1.0f / sqrtf((float)HEAD_DIM), drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Args o = a;
  o.in = att; o.ldi = C; o.cin = C; o.mask_in = 0;
  o.w = w.wo; o.bias = w.bo; o.n_out = C; o.out = x1; o.ldo = C;
  o.res = x; o.ldr = C; o.mask_res = 1; o.mask_acc = 0; o.gamma = w.g1; o.beta = w.be1;
  o.zhat = zhat1; o.rinv = rinv1; o.ldz = C;
  o.stream_add = SITE_ATTN_Y * 16; o.drop_ld = C;
  err = product<Tag, 1, LN_TN, LN>(o, B, s);
  if (err != cudaSuccess) return err;

  Args f1 = a;
  f1.in = x1; f1.ldi = C; f1.cin = C; f1.mask_in = 1;
  f1.w = pk.w1; f1.bias = w.b1; f1.n_out = F; f1.out = hid; f1.ldo = F;
  f1.stream_add = SITE_FFN_MID * 16; f1.drop_ld = F;
  err = product_taps<Tag, 128, RELU_MASK>(sh.kernel_size, f1, B, s);
  if (err != cudaSuccess) return err;

  Args f2 = a;
  f2.in = hid; f2.ldi = F; f2.cin = F; f2.mask_in = 1;
  f2.w = pk.w2; f2.bias = w.b2; f2.n_out = C; f2.out = out; f2.ldo = C;
  f2.res = x1; f2.ldr = C; f2.mask_res = 0; f2.mask_acc = 1; f2.gamma = w.g2; f2.beta = w.be2;
  f2.zhat = zhat2; f2.rinv = rinv2; f2.ldz = C;
  f2.stream_add = SITE_FFN_Y * 16; f2.drop_ld = C;
  return product_taps<Tag, LN_TN, LN>(sh.kernel_size, f2, B, s);
}

}  // namespace enc_layer
