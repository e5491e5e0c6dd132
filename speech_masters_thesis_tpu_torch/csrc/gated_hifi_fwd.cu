// GatedHiFi block forward for Hopper (sm_90a), fp32, dropout off.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/gated_hifi.py, function
// fused_gated_hifi -> _fwd -> _fwd_kernel (the TPU kernel's forward). The
// recompute backward (_bwd_kernel) and the in-kernel dropout are not ported.
//
// What it computes, per sequence b and frame t (x pre-masked, H = 2W):
//   z_d   = x W_d + b_d                       (4 branch 1x1 expands)
//   a_d   = relu(z_d), zero outside [0, T)    (the convs' zero padding)
//   c_d   = dilated_conv_d(a_d) + cb_d        (kernel k_d, dilation dil_d)
//   zp_d  = z_d + scale * (relu(c_d) W1_d + b1_d)
//   u     = sum_d tanh(zp_d[:, :W]) * softmax_d(zp_d[:, W:])
//   out   = (x + scale * (u Wg + bg)) * [t < min(T, lens[b])]
//
// What bounds it on an H100: arithmetic, and the latency of the weight
// loads that feed it. At W=64, H=128 and kernels (3,5,7,9) a frame costs
// about 1 MFLOP, nearly all of it in the dilated convs, against 512 bytes of
// input and output. Every intermediate ([T, 4H] expands, convs, branch
// outputs) would otherwise go through device memory; here none does. The
// weights (about 1.6 MB) stay in L2, but the tile fills 217 KB of shared
// memory, so L1 keeps little of them and one block (8 warps) per SM must
// hide L2 latency: the channel loops are unrolled 8 deep so each warp keeps
// 16 weight loads in flight (2 deep ran 1.5x slower on the card).
//
// Design: one thread block per (time tile of TT=64 frames, sequence). The
// x window with the largest halo (4*27 = 108 frames at the shipped config)
// is staged once in shared memory. The branches run in a loop; branch d
// recomputes its expand over its own halo (1, 6, 27 or 108 frames), runs
// the conv for the TT centre rows, then the 1x1, and folds the branch into
// an online softmax over branches (running max, denominator and
// sum tanh(t)*exp(s-max)) held in registers, so only [TT, W] state lives
// across branches. The conv output (and at the end u) reuses the first TT
// rows of the expand buffer, which is what lets a 64-frame tile fit.
// Products are plain fp32 FMA (no tensor cores: TF32 would not meet the
// fp32 tolerance). Each thread owns 4 rows x 8 columns (4 shared loads and
// two 16-byte weight loads per 32 FMAs); its rows are strided by 16 so the
// 16 row lanes of a warp read 16 different banks (rows padded by one
// float), and each weight element is read once per block. wgmma and TMA
// are later work.
//
// Shared memory: (TT + 2*max_halo) * ((W+1) + (2W+1)) floats, 217,280 bytes
// at the shipped config (one block per SM).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int W = 64;
constexpr int H = 2 * W;
constexpr int TT = 64;
constexpr int NT = 256;
constexpr int MAX_DEPTH = 8;
constexpr int XS = W + 1;  // padded row strides (bank-conflict-free row reads)
constexpr int AS = H + 1;

struct Branches {
  int depth;
  int max_halo;
  int k[MAX_DEPTH];
  int dil[MAX_DEPTH];
  int k_off[MAX_DEPTH];  // offset of branch d's [k, H, H] conv kernel in ks
};

size_t smem_bytes(int max_halo) {
  const size_t rows = TT + 2 * (size_t)max_halo;
  return sizeof(float) * rows * (XS + AS);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[j] += v * (w0, w1)[j] for the 8 columns of two float4s
__device__ __forceinline__ void fma8(float (&acc)[8], float v, float4 w0, float4 w1) {
  acc[0] = fmaf(v, w0.x, acc[0]);
  acc[1] = fmaf(v, w0.y, acc[1]);
  acc[2] = fmaf(v, w0.z, acc[2]);
  acc[3] = fmaf(v, w0.w, acc[3]);
  acc[4] = fmaf(v, w1.x, acc[4]);
  acc[5] = fmaf(v, w1.y, acc[5]);
  acc[6] = fmaf(v, w1.z, acc[6]);
  acc[7] = fmaf(v, w1.w, acc[7]);
}

__global__ void __launch_bounds__(NT) gated_hifi_fwd_kernel(
    const float* __restrict__ x, const int* __restrict__ lens,
    const float* __restrict__ wall, const float* __restrict__ ball,
    const float* __restrict__ ks, const float* __restrict__ cb,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wg, const float* __restrict__ bg,
    float* __restrict__ out, int T, float scale, Branches br) {
  extern __shared__ float smem[];
  const int R = TT + 2 * br.max_halo;
  float* xs = smem;          // [R][XS]  x window, zero outside [0, T)
  float* as = xs + R * XS;   // [R][AS]  relu(expand); rows [0, TT) then hold
                             //          relu(conv), and at the end u

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane & 15;             // this thread's rows: rg + 16*i, i < 4
  const int cg = lane >> 4;
  const int n8 = warp * 16 + cg * 8;    // its 8 columns of H (expand, conv)
  const int n4 = warp * 8 + cg * 4;     // its 4 columns of W (t/s pairs, gate)
  const int ldw = br.depth * H;         // row stride of wall
  const float* xb = x + (size_t)b * T * W;

  for (int i = tid; i < R * W; i += NT) {
    const int r = i / W, c = i % W;
    const int t = t0 - br.max_halo + r;
    xs[r * XS + c] = (t >= 0 && t < T) ? xb[(size_t)t * W + c] : 0.f;
  }
  __syncthreads();

  // online softmax over branches for (row rg+16i, column n4+j) of the t/s halves
  float m_run[4][4], den[4][4], num[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m_run[i][j] = -INFINITY;
      den[i][j] = 0.f;
      num[i][j] = 0.f;
    }

  for (int d = 0; d < br.depth; ++d) {
    const int k = br.k[d], dil = br.dil[d];
    const int half = (k - 1) / 2;
    const int halo = half * dil;
    const int Rd = TT + 2 * halo;
    const int xoff = br.max_halo - halo;  // xs row of this branch's window row 0

    // expand: as[r] = relu(x[r] W_d + b_d), zero outside [0, T)
    {
      const float* wd = wall + d * H + n8;
      for (int r0 = 0; r0 < Rd; r0 += TT) {
        float acc[4][8] = {};
#pragma unroll 8
        for (int c = 0; c < W; ++c) {
          const float4 w0 = ld4(wd + (size_t)c * ldw), w1v = ld4(wd + (size_t)c * ldw + 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + rg + 16 * i;
            fma8(acc[i], r < Rd ? xs[(xoff + r) * XS + c] : 0.f, w0, w1v);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + rg + 16 * i;
          if (r >= Rd) continue;
          const int t = t0 - halo + r;
          const bool inside = t >= 0 && t < T;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            as[r * AS + n8 + j] = inside ? fmaxf(acc[i][j] + ball[d * H + n8 + j], 0.f) : 0.f;
        }
      }
    }
    __syncthreads();

    // dilated conv at the TT centre rows: relu(sum_j a[t + (j-half)*dil] K_d[j] + cb_d)
    {
      float acc[4][8] = {};
      const float* kd = ks + br.k_off[d] + n8;
      for (int j = 0; j < k; ++j) {
        const float* arow = as + (rg + halo + (j - half) * dil) * AS;
        const float* kj = kd + (size_t)j * H * H;
#pragma unroll 8
        for (int c = 0; c < H; ++c) {
          const float4 w0 = ld4(kj + (size_t)c * H), w1v = ld4(kj + (size_t)c * H + 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) fma8(acc[i], arow[16 * i * AS + c], w0, w1v);
        }
      }
      __syncthreads();  // every conv read of `as` is done; rows [0, TT) are free
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          as[(rg + 16 * i) * AS + n8 + j] = fmaxf(acc[i][j] + cb[d * H + n8 + j], 0.f);
    }
    __syncthreads();

    // zp = scale * (h1 W1 + b1) + x W_d + b_d at the centre rows, t/s columns
    // paired, then folded into the online softmax
    {
      float zt[4][4] = {}, zs[4][4] = {};
      const float* w1d = w1 + (size_t)d * H * H;
#pragma unroll 8
      for (int c = 0; c < H; ++c) {
        const float4 wt = ld4(w1d + (size_t)c * H + n4), wsv = ld4(w1d + (size_t)c * H + W + n4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float h = as[(rg + 16 * i) * AS + c];
          zt[i][0] = fmaf(h, wt.x, zt[i][0]);
          zt[i][1] = fmaf(h, wt.y, zt[i][1]);
          zt[i][2] = fmaf(h, wt.z, zt[i][2]);
          zt[i][3] = fmaf(h, wt.w, zt[i][3]);
          zs[i][0] = fmaf(h, wsv.x, zs[i][0]);
          zs[i][1] = fmaf(h, wsv.y, zs[i][1]);
          zs[i][2] = fmaf(h, wsv.z, zs[i][2]);
          zs[i][3] = fmaf(h, wsv.w, zs[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          zt[i][j] = scale * (zt[i][j] + b1[d * H + n4 + j]);
          zs[i][j] = scale * (zs[i][j] + b1[d * H + W + n4 + j]);
        }
      const float* wd = wall + d * H;
#pragma unroll 8
      for (int c = 0; c < W; ++c) {
        const float4 wt = ld4(wd + (size_t)c * ldw + n4), wsv = ld4(wd + (size_t)c * ldw + W + n4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[(br.max_halo + rg + 16 * i) * XS + c];
          zt[i][0] = fmaf(xv, wt.x, zt[i][0]);
          zt[i][1] = fmaf(xv, wt.y, zt[i][1]);
          zt[i][2] = fmaf(xv, wt.z, zt[i][2]);
          zt[i][3] = fmaf(xv, wt.w, zt[i][3]);
          zs[i][0] = fmaf(xv, wsv.x, zs[i][0]);
          zs[i][1] = fmaf(xv, wsv.y, zs[i][1]);
          zs[i][2] = fmaf(xv, wsv.z, zs[i][2]);
          zs[i][3] = fmaf(xv, wsv.w, zs[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float tv = zt[i][j] + ball[d * H + n4 + j];
          const float sv = zs[i][j] + ball[d * H + W + n4 + j];
          const float m_new = fmaxf(m_run[i][j], sv);
          const float corr = expf(m_run[i][j] - m_new);
          const float e = expf(sv - m_new);
          den[i][j] = den[i][j] * corr + e;
          num[i][j] = num[i][j] * corr + tanhf(tv) * e;
          m_run[i][j] = m_new;
        }
    }
    __syncthreads();  // the next expand overwrites `as`, which was just read
  }

  // u -> as rows [0, TT), columns [0, W); then the gate and the residual
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) as[(rg + 16 * i) * AS + n4 + j] = num[i][j] / den[i][j];
  __syncthreads();

  float acc[4][4] = {};
#pragma unroll 8
  for (int c = 0; c < W; ++c) {
    const float4 wv = ld4(wg + (size_t)c * W + n4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float u = as[(rg + 16 * i) * AS + c];
      acc[i][0] = fmaf(u, wv.x, acc[i][0]);
      acc[i][1] = fmaf(u, wv.y, acc[i][1]);
      acc[i][2] = fmaf(u, wv.z, acc[i][2]);
      acc[i][3] = fmaf(u, wv.w, acc[i][3]);
    }
  }
  const int len = min(T, lens[b]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + rg + 16 * i;
    if (t >= T) continue;
    const float* xr = xs + (br.max_halo + rg + 16 * i) * XS + n4;
    const bool valid = t < len;
    float4 o;
    o.x = valid ? xr[0] + scale * (acc[i][0] + bg[n4 + 0]) : 0.f;
    o.y = valid ? xr[1] + scale * (acc[i][1] + bg[n4 + 1]) : 0.f;
    o.z = valid ? xr[2] + scale * (acc[i][2] + bg[n4 + 2]) : 0.f;
    o.w = valid ? xr[3] + scale * (acc[i][3] + bg[n4 + 3]) : 0.f;
    *reinterpret_cast<float4*>(out + ((size_t)b * T + t) * W + n4) = o;
  }
}

}  // namespace

extern "C" long gated_hifi_fwd_smem_bytes(int max_halo) { return (long)smem_bytes(max_halo); }

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// kernels/dilations are host arrays of `depth` entries. All tensors are
// contiguous float32 on the device (lens int32): x/out [B, T, width],
// wall [width, depth*2*width], ball [depth*2*width], ks the branches'
// [k_d, H, H] kernels back to back, cb/b1 [depth, H], w1 [depth, H, H],
// wg [width, width], bg [width].
extern "C" int gated_hifi_fwd(const float* x, const int* lens, const float* wall,
                              const float* ball, const float* ks, const float* cb,
                              const float* w1, const float* b1, const float* wg,
                              const float* bg, float* out, int B, int T, int width,
                              int depth, const int* kernels, const int* dilations,
                              float scale, void* stream) {
  if (width != W || depth < 1 || depth > MAX_DEPTH || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  Branches br{};
  br.depth = depth;
  int off = 0;
  for (int d = 0; d < depth; ++d) {
    if (kernels[d] < 1 || kernels[d] % 2 == 0 || dilations[d] < 1) return (int)cudaErrorInvalidValue;
    br.k[d] = kernels[d];
    br.dil[d] = dilations[d];
    br.k_off[d] = off;
    off += kernels[d] * H * H;
    const int halo = (kernels[d] - 1) / 2 * dilations[d];
    br.max_halo = halo > br.max_halo ? halo : br.max_halo;
  }
  const size_t smem = smem_bytes(br.max_halo);
  cudaError_t err = cudaFuncSetAttribute(gated_hifi_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  gated_hifi_fwd_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, lens, wall, ball, ks, cb, w1, b1, wg, bg, out, T, scale, br);
  return (int)cudaGetLastError();
}
