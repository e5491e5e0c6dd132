// A row-tiled 1-D convolution over [B, T, C] activations with fused
// epilogues, shared by the Glow-TTS kernels (wn_coupling_fwd.cu,
// enc_layer_fwd.cu). fp32 on the CUDA cores.
//
//   z[b, t, n] = bias[n] + sum_{tap, c} in[b, t + tap * dil - pad, c] * w[n, c, tap]
//
// with pad = (taps - 1) / 2 * dil, zero rows outside [0, T) and, when
// mask_in is set, at t >= lens[b]; w in PyTorch's Conv1d layout
// [n_out, c_in, taps]. Each block computes TR rows of one sequence and TN
// output channels: the input rows (with the halo) and the weights stream
// through shared memory KC input channels at a time; each of the 256
// threads accumulates RM = TR / 8 rows by RN = TN / 32 channels in
// registers (rows broadcast, channels 32 apart, so shared-memory reads are
// conflict-free). The tile of z then goes through shared memory to the
// epilogue:
//   BIAS      out = z
//   MASK      out = z * valid(t)
//   RELU_MASK out = max(z, 0) * valid(t)
//   GATE      channel pairs (p, hidden + p) of one tile: out[p] = tanh(z_p) * sigmoid(z_{H+p})
//   RES_SKIP  channels n < n_out - hidden: out[n] = (res[n] + z) * valid(t) (may be in place);
//             the last hidden channels: skip[n'] = (first ? 0 : skip[n']) + z
//   LN        z' = z * (mask_acc ? valid(t) : 1) + res * (mask_res ? valid(t) : 1),
//             then LayerNorm over the row (flax: var = E[z'^2] - E[z']^2, clamped
//             at 0), times gamma plus beta; needs TN == n_out
// valid(t) = t < lens[b]. The kernel template carries a tag type so each
// translation unit that includes this header has kernels of its own names.

#pragma once

#include <cuda_runtime.h>

namespace conv_rows {

enum Epilogue : int { BIAS = 0, MASK = 1, RELU_MASK = 2, GATE = 3, RES_SKIP = 4, LN = 5 };

constexpr int NT = 256;  // threads per block: 32 channel groups x 8 row groups
constexpr int KC = 16;   // input channels per shared-memory stage

struct Args {
  const float* in;
  int ldi, cin, mask_in;
  const float* w;     // [n_out, cin, taps]
  const float* bias;  // [n_out]
  int n_out, dil;
  float* out;
  int ldo;
  const float* res;   // RES_SKIP: the residual stream (read), LN: the residual
  int ldr, mask_res, mask_acc;
  float* skip;        // RES_SKIP: the skip sum
  int lds, first;
  const float* gamma;
  const float* beta;
  float eps;
  int hidden;         // GATE, RES_SKIP
  const int* lens;
  int T;
};

template <int TAPS, int TR, int TN>
inline size_t smem_bytes(int dil) {
  const int pad = (TAPS - 1) / 2 * dil;
  return sizeof(float) * ((size_t)(TR + 2 * pad) * KC + (size_t)KC * TAPS * (TN + 1) +
                          (size_t)TR * (TN + 1));
}

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

template <class Tag, int TAPS, int TR, int TN, int EPI>
__global__ void __launch_bounds__(NT) conv_rows_kernel(Args a) {
  constexpr int RM = TR / 8, RN = TN / 32;
  extern __shared__ float smem[];
  const int pad = (TAPS - 1) / 2 * a.dil;
  const int xrows = TR + 2 * pad;
  float* xs = smem;                         // [xrows][KC]
  float* ws = xs + xrows * KC;              // [KC * TAPS][TN + 1]
  float* zs = ws + KC * TAPS * (TN + 1);    // [TR][TN + 1]

  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int b = blockIdx.z, r0 = blockIdx.x * TR;
  const int len = a.lens[b];
  const size_t row0 = (size_t)b * a.T;

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[r][q] = 0.0f;

  for (int c0 = 0; c0 < a.cin; c0 += KC) {
    for (int e = tid; e < xrows * KC; e += NT) {
      const int rr = e / KC, c = e % KC, t = r0 - pad + rr, ch = c0 + c;
      float x = 0.0f;
      if (t >= 0 && t < a.T && ch < a.cin && (!a.mask_in || t < len)) x = a.in[(row0 + t) * a.ldi + ch];
      xs[rr * KC + c] = x;
    }
    for (int e = tid; e < TN * KC * TAPS; e += NT) {
      const int j = e / (KC * TAPS), kk = e % (KC * TAPS), ch = c0 + kk / TAPS;
      int col;
      float wv = 0.0f;
      if (out_column<TN, EPI>(a, j, &col) && ch < a.cin) wv = a.w[((size_t)col * a.cin + ch) * TAPS + kk % TAPS];
      ws[kk * (TN + 1) + j] = wv;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC * TAPS; ++kk) {
      const int c = kk / TAPS, tap = kk % TAPS;
      float xv[RM], wv[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) xv[r] = xs[(ty * RM + r + tap * a.dil) * KC + c];
#pragma unroll
      for (int q = 0; q < RN; ++q) wv[q] = ws[kk * (TN + 1) + tx + 32 * q];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[r][q] = fmaf(xv[r], wv[q], acc[r][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < RN; ++q) {
    int col;
    const int j = tx + 32 * q;
    const float bv = out_column<TN, EPI>(a, j, &col) ? a.bias[col] : 0.0f;
#pragma unroll
    for (int r = 0; r < RM; ++r) zs[(ty * RM + r) * (TN + 1) + j] = acc[r][q] + bv;
  }
  __syncthreads();

  if (EPI == LN) {
    // one warp per row; TN == n_out
    for (int rl = ty; rl < TR; rl += NT / 32) {
      const int t = r0 + rl;
      if (t >= a.T) continue;
      const float valid = t < len ? 1.0f : 0.0f;
      const float za = a.mask_acc ? valid : 1.0f, zr = a.mask_res ? valid : 1.0f;
      const float* res = a.res + (row0 + t) * a.ldr;
      float s = 0.0f, sq = 0.0f;
      for (int j = tx; j < TN; j += 32) {
        const float z = zs[rl * (TN + 1) + j] * za + res[j] * zr;
        zs[rl * (TN + 1) + j] = z;
        s += z;
        sq += z * z;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      const float mean = s / TN;
      const float inv = rsqrtf(fmaxf(sq / TN - mean * mean, 0.0f) + a.eps);
      float* out = a.out + (row0 + t) * a.ldo;
      for (int j = tx; j < TN; j += 32) out[j] = (zs[rl * (TN + 1) + j] - mean) * inv * a.gamma[j] + a.beta[j];
    }
    return;
  }
  if (EPI == GATE) {
    constexpr int half = TN / 2;
    for (int e = tid; e < TR * half; e += NT) {
      const int rl = e / half, j = e % half, t = r0 + rl, p = blockIdx.y * half + j;
      if (t >= a.T || p >= a.hidden) continue;
      const float zt = zs[rl * (TN + 1) + j], zg = zs[rl * (TN + 1) + half + j];
      a.out[(row0 + t) * a.ldo + p] = tanhf(zt) * (1.0f / (1.0f + expf(-zg)));
    }
    return;
  }
  for (int e = tid; e < TR * TN; e += NT) {
    const int rl = e / TN, j = e % TN, t = r0 + rl;
    int col;
    if (t >= a.T || !out_column<TN, EPI>(a, j, &col)) continue;
    const float valid = t < len ? 1.0f : 0.0f;
    const float z = zs[rl * (TN + 1) + j];
    if (EPI == RES_SKIP) {
      const int n_res = a.n_out - a.hidden;
      if (col < n_res) {
        a.out[(row0 + t) * a.ldo + col] = (a.res[(row0 + t) * a.ldr + col] + z) * valid;
      } else {
        float* s = a.skip + (row0 + t) * a.lds + (col - n_res);
        *s = a.first ? z : *s + z;
      }
    } else {
      float v = z;
      if (EPI == MASK) v = z * valid;
      if (EPI == RELU_MASK) v = fmaxf(z, 0.0f) * valid;
      a.out[(row0 + t) * a.ldo + col] = v;
    }
  }
}

// One launch: grid (row tiles, channel tiles, B).
template <class Tag, int TAPS, int TR, int TN, int EPI>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<TAPS, TR, TN>(a.dil);
  auto kernel = conv_rows_kernel<Tag, TAPS, TR, TN, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int tiles;
  if (EPI == GATE) tiles = (a.hidden + TN / 2 - 1) / (TN / 2);
  else if (EPI == LN) tiles = 1;
  else tiles = (a.n_out + TN - 1) / TN;
  const dim3 grid((a.T + TR - 1) / TR, tiles, B);
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// The same with the number of taps chosen at run time (1, 3 or 5).
template <class Tag, int TR, int TN, int EPI>
cudaError_t launch_taps(int taps, const Args& a, int B, cudaStream_t stream) {
  switch (taps) {
    case 1: return launch<Tag, 1, TR, TN, EPI>(a, B, stream);
    case 3: return launch<Tag, 3, TR, TN, EPI>(a, B, stream);
    case 5: return launch<Tag, 5, TR, TN, EPI>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace conv_rows
