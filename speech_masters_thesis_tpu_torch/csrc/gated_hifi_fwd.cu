// GatedHiFi block forward for Hopper (sm_90a), fp32, with in-kernel dropout.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/gated_hifi.py, function
// fused_gated_hifi -> _fwd -> _fwd_kernel (the TPU kernel's forward), and
// its dropout (_branch_masks, _mix). The backward is gated_hifi_bwd.cu.
//
// What it computes, per sequence b and frame t (x pre-masked, H = 2W):
//   z_d   = x W_d + b_d                       (4 branch 1x1 expands)
//   a_d   = relu(z_d) * m0_d, zero outside [0, T)  (the convs' zero padding)
//   c_d   = dilated_conv_d(a_d) + cb_d        (kernel k_d, dilation dil_d)
//   zp_d  = z_d + scale * ((relu(c_d) * m1_d) W1_d + b1_d)
//   u     = sum_d tanh(zp_d[:, :W]) * softmax_d(zp_d[:, W:])
//   out   = (x + scale * (u Wg + bg)) * [t < min(T, lens[b])]
// m0_d and m1_d are the dropout masks (gated_hifi_common.cuh); with p = 0
// the kernel is instantiated without them and does no hashing.
//
// What bounds it on an H100: arithmetic, and the latency of the weight
// loads that feed it. At W=64, H=128 and kernels (3,5,7,9) a frame costs
// about 1 MFLOP, nearly all of it in the dilated convs, against 512 bytes of
// input and output. Every intermediate ([T, 4H] expands, convs, branch
// outputs) would otherwise go through device memory; here none does. The
// weights (about 1.6 MB) stay in L2, but the tile fills 217 KB of shared
// memory, so L1 keeps little of them and one block (8 warps) per SM must
// hide L2 latency: the channel loops are unrolled 8 deep so each warp keeps
// 16 weight loads in flight (2 deep ran 1.5x slower on the card). The mask
// hash costs about 20 integer operations per element and draw, against
// 64 FMAs per element of the expand and 384-1152 of the conv.
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

#include "gated_hifi_common.cuh"

#include <math.h>

namespace gated_hifi {
namespace {

template <bool DROP>
__global__ void __launch_bounds__(NT, 1) gated_hifi_fwd_kernel(
    const float* __restrict__ x, const int* __restrict__ lens,
    const float* __restrict__ wall, const float* __restrict__ ball,
    const float* __restrict__ ks, const float* __restrict__ cb,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wg, const float* __restrict__ bg,
    float* __restrict__ out, int T, float scale, Branches br, Dropout drop) {
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
    const int halo = (k - 1) / 2 * dil;
    const uint32_t key = DROP ? dropout_key(drop.seed, b, d) : 0u;

    // expand: as[r] = relu(x[r] W_d + b_d) * m0 over the branch's window
    expand_tile<DROP>(as, xs, wall, ball, d, ldw, TT + 2 * halo, br.max_halo - halo, t0 - halo,
                      halo, T, key, drop, rg, n8, nullptr);
    __syncthreads();

    // dilated conv at the TT centre rows: relu(sum_j a[t + (j-half)*dil] K_d[j] + cb_d) * m1
    {
      float acc[4][8] = {};
      conv_tile(acc, as, ks + br.k_off[d] + n8, k, rg, dil);
      __syncthreads();  // every conv read of `as` is done; rows [0, TT) are free
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float h = fmaxf(acc[i][j] + cb[d * H + n8 + j], 0.f);
          if (DROP)
            h *= (dropout_bits(key, t, n8 + j) & 0xFFFFu) >= drop.threshold ? drop.scale : 0.f;
          as[(rg + 16 * i) * AS + n8 + j] = h;
        }
      }
    }
    __syncthreads();

    // the branch output at the centre rows, folded into the online softmax
    {
      float tv[4][4], sv[4][4];
      branch_out_tile(tv, sv, as, xs, wall, ball, w1, b1, d, ldw, br.max_halo, scale, rg, n4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float m_new = fmaxf(m_run[i][j], sv[i][j]);
          const float corr = expf(m_run[i][j] - m_new);
          const float e = expf(sv[i][j] - m_new);
          den[i][j] = den[i][j] * corr + e;
          num[i][j] = num[i][j] * corr + tanhf(tv[i][j]) * e;
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
    for (int i = 0; i < 4; ++i) fma4(acc[i], as[(rg + 16 * i) * AS + c], wv);
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

template <bool DROP>
cudaError_t launch(const float* x, const int* lens, const float* wall, const float* ball,
                   const float* ks, const float* cb, const float* w1, const float* b1,
                   const float* wg, const float* bg, float* out, int B, int T, float scale,
                   const Branches& br, const Dropout& drop, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(br.max_halo);
  cudaError_t err = cudaFuncSetAttribute(gated_hifi_fwd_kernel<DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TT - 1) / TT, B);
  gated_hifi_fwd_kernel<DROP><<<grid, NT, smem, stream>>>(
      x, lens, wall, ball, ks, cb, w1, b1, wg, bg, out, T, scale, br, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gated_hifi

extern "C" long gated_hifi_fwd_smem_bytes(int max_halo) {
  return (long)gated_hifi::tile_smem_bytes(max_halo);
}

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// kernels/dilations are host arrays of `depth` entries. All tensors are
// contiguous float32 on the device (lens int32): x/out [B, T, width],
// wall [width, depth*2*width], ball [depth*2*width], ks the branches'
// [k_d, H, H] kernels back to back, cb/b1 [depth, H], w1 [depth, H, H],
// wg [width, width], bg [width]. Dropout keeps an element when its 16-bit
// field is >= threshold and scales it by keep_scale; threshold 0 is p = 0.
extern "C" int gated_hifi_fwd(const float* x, const int* lens, const float* wall,
                              const float* ball, const float* ks, const float* cb,
                              const float* w1, const float* b1, const float* wg,
                              const float* bg, float* out, int B, int T, int width,
                              int depth, const int* kernels, const int* dilations,
                              float scale, unsigned seed, unsigned threshold,
                              float keep_scale, void* stream) {
  using namespace gated_hifi;
  Branches br;
  if (width != W || B < 1 || T < 1 || !make_branches(depth, kernels, dilations, &br))
    return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      threshold ? launch<true>(x, lens, wall, ball, ks, cb, w1, b1, wg, bg, out, B, T, scale, br, drop, s)
                : launch<false>(x, lens, wall, ball, ks, cb, w1, b1, wg, bg, out, B, T, scale, br, drop, s);
  return (int)err;
}
