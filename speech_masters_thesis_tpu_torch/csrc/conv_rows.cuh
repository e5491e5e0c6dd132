// The arguments and the fused epilogues of a row-tiled 1-D convolution over
// [B, T, C] activations, which conv_mma.cuh runs on the tensor cores for the
// Glow-TTS kernels (B3's and B6's epilogues MASK, GATE, GATE_BWD,
// ACTNORM_FWD and ACTNORM_BWD; B5's RELU_MASK, LN, LN_BWD and DRELU; both
// BIAS and RES_SKIP).
//
//   z[b, t, n] = bias[n] + sum_{tap, c} in[b, t + tap * dil - pad, c] * w[n, c, tap]
//
// with pad = (taps - 1) / 2 * dil, zero rows outside [0, T) and, when
// mask_in is set, at t >= lens[b] (ACTNORM_FWD: an ActNorm applied to what
// the loader reads, pre_bias[c] + exp(pre_logs[c]) * in); w in
// PyTorch's Conv1d layout
// [n_out, c_in, taps]. With `wt` set, w is the weight of the conv being
// transposed ([c_in, n_out, taps]) and is read as w[c, n, taps - 1 - tap]:
// the launch then computes that conv's input gradient. Input channels at or
// past `split` come from in2 (rows ldi2 apart) when in2 is set. bias may be
// null. A block computes TR rows of one sequence and TN output channels and
// hands its tile of z, in shared memory, to the epilogue:
//   BIAS      out = z
//   MASK      out = z * valid(t)
//   RELU_MASK out = max(z, 0) * drop * valid(t)
//   GATE      channel pairs (p, hidden + p) of one tile: zt = z_p * drop, zg = z_{H+p} * drop,
//             out[p] = tanh(zt) * sigmoid(zg); with xin set, xin[p] = zt and xin[H + p] = zg
//   RES_SKIP  channels n < n_out - hidden: out[n] = (res[n] + z) * valid(t) (may be in place);
//             the last hidden channels: skip[n'] = (first ? 0 : skip[n']) + z
//   LN        z' = z * (mask_acc ? valid(t) : 1) * drop + res * (mask_res ? valid(t) : 1),
//             then LayerNorm over the row (flax: var = E[z'^2] - E[z']^2, clamped
//             at 0), times gamma plus beta; zhat (rows ldz apart) and rinv [B*T]
//             get the normalised row and 1/std when set; needs TN == n_out
//   GATE_BWD z is the gate output's cotangent for channel p < hidden; with zt, zg
//             read from xin: out[p] = z * sigmoid(zg) * (1 - tanh(zt)^2) * drop,
//             out[hidden + p] = z * tanh(zt) * sigmoid(zg) * (1 - sigmoid(zg)) * drop
//   LN_BWD    dx = z * (mask_acc ? valid(t) : 1) + res * (mask_res ? valid(t) : 1) is a
//             LayerNorm output's cotangent; with zhat and rinv of its forward:
//             out = rinv * (dy - mean(dy) - zhat * mean(dy * zhat)), dy = dx * gamma;
//             out2 = dx and out3 = out * drop * valid(t) when set; needs TN == n_out
//   DRELU     out = res > 0 ? z * (dropout ? keep_scale : 1) : 0 (res: the relu's
//             output after dropout and the mask)
//   ACTNORM_FWD out = z, the input through an ActNorm in the loader; with in_out set
//             (one tap), the blocks of the first channel tile also write the rows
//             they load, after the ActNorm and the mask, to in_out (rows ldio apart)
//   ACTNORM_BWD out2 = z * valid(t) and out = out2 * exp(out_logs[n]) (rows ldo apart):
//             an ActNorm's input cotangent from its output's
// valid(t) = t < lens[b]. drop is 1 without dropout (threshold 0), else the
// factor of (row t, output column n): hash_draw(stream_key(seed, b *
// stream_mul + stream_add), t * drop_ld + n) >= threshold ? keep_scale : 0
// (hash.cuh; the plain versions draw the same bits). The kernel template
// carries a tag type so each translation unit that includes this header has
// kernels of its own names. Every buffer is fp32 (the bf16 kernels run
// bf16_engine.cuh's engine).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace conv_rows {

enum Epilogue : int { BIAS = 0, MASK = 1, RELU_MASK = 2, GATE = 3, RES_SKIP = 4, LN = 5, GATE_BWD = 6,
                      LN_BWD = 7, DRELU = 8, ACTNORM_FWD = 9, ACTNORM_BWD = 10 };

constexpr int NT = 256;  // threads per block

struct Args {
  const float* in;
  int ldi, cin, mask_in;
  const float* pre_logs;  // ACTNORM_FWD: the loader's ActNorm
  const float* pre_bias;
  float* in_out;          // ACTNORM_FWD, one tap: the loaded rows written back (rows ldio apart), or null
  int ldio;
  const float* in2;   // channels >= split (when set)
  int ldi2, split;
  const float* w;     // [n_out, cin, taps], or with wt [cin, n_out, taps]
  int wt;
  const float* bias;  // [n_out] or null
  int n_out, dil;
  float* out;
  int ldo;
  const float* res;   // RES_SKIP: the residual stream (read), LN/LN_BWD: the residual, DRELU: the relu output
  int ldr, mask_res, mask_acc;
  float* skip;        // RES_SKIP: the skip sum
  int lds, first;
  const float* gamma;
  const float* beta;
  float eps;
  int hidden;         // GATE, GATE_BWD, RES_SKIP
  float* xin;         // GATE: post-dropout z (written when set); GATE_BWD: read
  int ldx;
  float* zhat;        // LN: written when set; LN_BWD: read
  float* rinv;
  int ldz;
  float* out2;        // LN_BWD, ACTNORM_BWD
  float* out3;        // LN_BWD
  const float* out_logs;  // ACTNORM_BWD
  const long long* seed;  // dropout: threshold 0 means none
  unsigned threshold;
  float keep_scale;
  int stream_mul, stream_add, drop_ld;
  const int* lens;
  int T;
};
static_assert(sizeof(Args) == 296, "the kernels' parameters keep their layout");

template <int TN, int EPI>
__device__ __forceinline__ bool out_column(const Args& a, int j, int* col) {
  if (EPI == GATE) {
    const int half = TN / 2;
    const int p = blockIdx.y * half + (j % half);
    *col = j < half ? p : a.hidden + p;
    return p < a.hidden;
  }
  *col = blockIdx.y * TN + j;
  return *col < a.n_out;
}

// the dropout factor of (row t, output column col) under `key`
__device__ __forceinline__ float drop_factor(const Args& a, uint32_t key, int t, int col) {
  if (!a.threshold) return 1.0f;
  return hash_draw(key, (uint32_t)t * (uint32_t)a.drop_ld + (uint32_t)col) >= a.threshold ? a.keep_scale : 0.0f;
}

// The epilogue of a tile, run by conv_mma.cuh's kernel (a macro: as an
// inline function it moved kernels' registers, PERF.md): the tile's TR rows start at r0 of the
// sequence whose rows start at row0 and whose length is len; zs holds z,
// the product plus the bias, for TR rows by TN columns (rows TN + 1 floats
// apart); a, key, tid, tx and ty are the kernel's (NT threads).
#define CONV_ROWS_EPILOGUE                                                                                         \
  if (EPI == LN || EPI == LN_BWD) {                                                                                \
    /* one warp per row; TN == n_out */                                                                            \
    for (int rl = ty; rl < TR; rl += NT / 32) {                                                                    \
      const int t = r0 + rl;                                                                                       \
      if (t >= a.T) continue;                                                                                      \
      const size_t row = row0 + t;                                                                                 \
      const float valid = t < len ? 1.0f : 0.0f;                                                                   \
      const float za = a.mask_acc ? valid : 1.0f, zr = a.mask_res ? valid : 1.0f;                                  \
      const float* res = a.res + row * a.ldr;                                                                      \
      float* z = zs + rl * (TN + 1);                                                                               \
      if (EPI == LN) {                                                                                             \
        float s = 0.0f, sq = 0.0f;                                                                                 \
        for (int j = tx; j < TN; j += 32) {                                                                        \
          const float v = z[j] * za * drop_factor(a, key, t, j) + res[j] * zr;                                     \
          z[j] = v;                                                                                                \
          s += v;                                                                                                  \
          sq += v * v;                                                                                             \
        }                                                                                                          \
_Pragma("unroll")                                                                                                  \
        for (int o = 16; o > 0; o >>= 1) {                                                                         \
          s += __shfl_xor_sync(0xffffffffu, s, o);                                                                 \
          sq += __shfl_xor_sync(0xffffffffu, sq, o);                                                               \
        }                                                                                                          \
        const float mean = s / TN;                                                                                 \
        const float inv = rsqrtf(fmaxf(sq / TN - mean * mean, 0.0f) + a.eps);                                      \
        if (a.rinv && tx == 0) a.rinv[row] = inv;                                                                  \
        float* out = a.out + row * a.ldo;                                                                          \
        for (int j = tx; j < TN; j += 32) {                                                                        \
          const float zh = (z[j] - mean) * inv;                                                                    \
          if (a.zhat) a.zhat[row * a.ldz + j] = zh;                                                                \
          out[j] = zh * a.gamma[j] + a.beta[j];                                                                    \
        }                                                                                                          \
      } else {                                                                                                     \
        const float* zh = a.zhat + row * a.ldz;                                                                    \
        float s1 = 0.0f, s2 = 0.0f;                                                                                \
        for (int j = tx; j < TN; j += 32) {                                                                        \
          const float dx = z[j] * za + res[j] * zr;                                                                \
          if (a.out2) a.out2[row * a.ldo + j] = dx;                                                                \
          const float dy = dx * a.gamma[j];                                                                        \
          z[j] = dy;                                                                                               \
          s1 += dy;                                                                                                \
          s2 += dy * zh[j];                                                                                        \
        }                                                                                                          \
_Pragma("unroll")                                                                                                  \
        for (int o = 16; o > 0; o >>= 1) {                                                                         \
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);                                                               \
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);                                                               \
        }                                                                                                          \
        const float m1 = s1 / TN, m2 = s2 / TN, inv = a.rinv[row];                                                 \
        for (int j = tx; j < TN; j += 32) {                                                                        \
          const float dz = inv * (z[j] - m1 - zh[j] * m2);                                                         \
          a.out[row * a.ldo + j] = dz;                                                                             \
          if (a.out3) a.out3[row * a.ldo + j] = dz * drop_factor(a, key, t, j) * valid;                            \
        }                                                                                                          \
      }                                                                                                            \
    }                                                                                                              \
    return;                                                                                                        \
  }                                                                                                                \
  if (EPI == GATE) {                                                                                               \
    constexpr int half = TN / 2;                                                                                   \
    for (int e = tid; e < TR * half; e += NT) {                                                                    \
      const int rl = e / half, j = e % half, t = r0 + rl, p = blockIdx.y * half + j;                               \
      if (t >= a.T || p >= a.hidden) continue;                                                                     \
      const float zt = zs[rl * (TN + 1) + j] * drop_factor(a, key, t, p);                                          \
      const float zg = zs[rl * (TN + 1) + half + j] * drop_factor(a, key, t, a.hidden + p);                        \
      if (a.xin) {                                                                                                 \
        a.xin[(row0 + t) * a.ldx + p] = zt;                                                                        \
        a.xin[(row0 + t) * a.ldx + a.hidden + p] = zg;                                                             \
      }                                                                                                            \
      a.out[(row0 + t) * a.ldo + p] = tanhf(zt) * (1.0f / (1.0f + expf(-zg)));                                     \
    }                                                                                                              \
    return;                                                                                                        \
  }                                                                                                                \
  for (int e = tid; e < TR * TN; e += NT) {                                                                        \
    const int rl = e / TN, j = e % TN, t = r0 + rl;                                                                \
    int col;                                                                                                       \
    if (t >= a.T || !out_column<TN, EPI>(a, j, &col)) continue;                                                    \
    const size_t row = row0 + t;                                                                                   \
    const float valid = t < len ? 1.0f : 0.0f;                                                                     \
    const float z = zs[rl * (TN + 1) + j];                                                                         \
    if (EPI == RES_SKIP) {                                                                                         \
      const int n_res = a.n_out - a.hidden;                                                                        \
      if (col < n_res) {                                                                                           \
        a.out[row * a.ldo + col] = (a.res[row * a.ldr + col] + z) * valid;                                         \
      } else {                                                                                                     \
        float* s = a.skip + row * a.lds + (col - n_res);                                                           \
        *s = a.first ? z : *s + z;                                                                                 \
      }                                                                                                            \
    } else if (EPI == GATE_BWD) {                                                                                  \
      const float zt = a.xin[row * a.ldx + col], zg = a.xin[row * a.ldx + a.hidden + col];                         \
      const float th = tanhf(zt), sg = 1.0f / (1.0f + expf(-zg));                                                  \
      a.out[row * a.ldo + col] = z * sg * (1.0f - th * th) * drop_factor(a, key, t, col);                          \
      a.out[row * a.ldo + a.hidden + col] = z * th * sg * (1.0f - sg) * drop_factor(a, key, t, a.hidden + col);    \
    } else if (EPI == ACTNORM_BWD) {                                                                               \
      const float v = z * valid;                                                                                   \
      a.out2[row * a.ldo + col] = v;                                                                               \
      a.out[row * a.ldo + col] = v * expf(a.out_logs[col]);                                                        \
    } else if (EPI == DRELU) {                                                                                     \
      a.out[row * a.ldo + col] = a.res[row * a.ldr + col] > 0.0f ? z * (a.threshold ? a.keep_scale : 1.0f) : 0.0f; \
    } else {                                                                                                       \
      float v = z;                                                                                                 \
      if (EPI == MASK) v = z * valid;                                                                              \
      if (EPI == RELU_MASK) v = fmaxf(z, 0.0f) * drop_factor(a, key, t, col) * valid;                              \
      a.out[row * a.ldo + col] = v;                                                                                \
    }                                                                                                              \
  }

}  // namespace conv_rows
