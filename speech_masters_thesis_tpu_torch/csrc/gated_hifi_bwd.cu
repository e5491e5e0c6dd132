// GatedHiFi block backward for Hopper (sm_90a), with the dropout masks
// regenerated from the seed, in the fp32 mode: fp32 at its interface with
// its products in 3xTF32 on the tensor cores (tf32_mma.cuh). The bf16 mode
// is gated_hifi_bwd_bf16.cu (TMA and wgmma).
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/gated_hifi.py, function
// _vjp_bwd -> _bwd -> _bwd_kernel (the TPU kernel's recompute backward,
// its weight sums at :360-454). Like it, this saves no residuals beyond x,
// lens, the weights and the seed: the forward is recomputed from x. What
// it computes, with the forward's names (gated_hifi_fwd.cu) and g the
// output's cotangent:
//   gv    = scale * g * [t < min(T, len)]             (d v)
//   du    = gv Wg^T;  dWg = u^T gv;  dbg = sum gv
//   dzp_d = [du p_d (1 - tanh^2 t_d),  du p_d (tanh t_d - u)]
//   dc_d  = scale * (dzp_d W1_d^T) * m1_d * [c_d > 0];  dW1_d = scale h1_d^T dzp_d
//   dK_d[j] = sum_t a_d[t + (j-half) dil]^T dc_d[t];     dcb_d = sum dc_d
//   dz_d  = dzp_d + (sum_j dc_d[t - (j-half) dil] K_d[j]^T) * m0_d * [z_d > 0]
//   dWall = x^T dz;  dx = g * [t < min(T, len)] + dz Wall^T
//
// Two things of the TPU kernel do not carry over to Hopper:
//  1. Its window. The TPU tile holds centre +- 2*halo of every branch in
//     VMEM so that one grid step produces dx. Branch 4's halo of 108 frames
//     would make that window 496 frames here, 254 KB for one branch's
//     expand alone, over the 227 KB a block may have. So the backward's
//     tile passes are stages that meet in device memory, in the buffers the
//     weight gradients need anyway (ops/gated_hifi.py:BackwardBuffers):
//       1-3 expand, conv, branch: the forward's stages (gated_hifi_tiles.cuh),
//           zp_d into dzp
//       4 gate     du = gv Wg^T; u, gv and dzp_d from zp_d in place
//       5 dc       dc_d  = scale * (dzp_d W1_d^T) * m1 * [c > 0]
//       6 convt    dz_d  = dzp_d + (sum_j dc_d[t - (j-half) dil] K_d[j]^T) * m0 * [z > 0]
//       7 dx       dx    = g' + dz Wall^T
//     Each stage is one launch of the shared tile (gated_hifi_tiles.cuh);
//     the transposed conv's taps are shifted k-slices of dc. The epilogues
//     apply bias, relu, the dropout masks and the gating.
//  2. Its weight gradients. The TPU accumulates them across its sequential
//     grid (@pl.when(first) ... += ...). Hopper's blocks run in parallel
//     and in no order, so every weight gradient is a product summed over
//     the B*T frames, computed as a split-over-frames reduction: each block
//     of wgrad_partial_kernel sums one slice of the frames for one product
//     (one conv tap of one branch, a branch 1x1, the gate, or 256 columns
//     of the expand) into its own partial, and wgrad_reduce_kernel adds the
//     slices in a fixed order. No float atomics: equal inputs give
//     bitwise-equal gradients.
//
// What bounds it: arithmetic. The tile passes cost twice the forward's
// multiply-adds (the recompute, then the transposed products), about 2
// MFLOP a frame, the reduction about 1, each 3x that on the tensor cores in
// 3xTF32; the stages move about 15 [B, T, depth*H] passes of device
// memory, the reduction reads its 7 buffers once. At 16 x 33024 that is
// 16 GB (4.7 ms at 3.35 TB/s) against 3.2 TFLOP of TF32 products (6.5 ms at
// 495 TF/s) for the tile passes, 3.2 GB against 1.6 TFLOP for the reduction.
//
// The reduction's design: out[M, N] = sum_r X[r + shift]^T Y[r] runs k =
// frames in m16n8k8 MMAs. Both operands are [frames x channels] slabs of
// 32 frames, double-buffered by cp.async (a frame whose t + shift
// leaves [0, T) is zero-filled); the A fragment is X^T, read transposed
// from shared memory, and rows 8 floats longer than the tile put lane
// (g, q) of a fragment read on bank 8q + g. A block's tile is 128 x 128
// (conv taps, branch 1x1s) or 64 x 256 (the expand's 64 input channels
// against 256 of its columns, so the 64-wide operand fills a whole tile;
// the gate's 64 x 64 uses a quarter of one); 8 warps of 32 x 64 each. A
// slice runs up to 3,100 MMAs into each accumulator, and the tensor cores'
// accumulation truncates each one's sum, which over a whole slice lost 30x
// the fp32 sum's accuracy on the card; so every 32 slabs (384 MMAs) the
// block adds its accumulators into its partial in fp32 and restarts them
// from zero. The partial keeps the tile in the accumulators' own order, so
// those adds are coalesced and cost no address registers (the 64
// accumulators a thread leave no room for a second set). The bias
// gradients are the column sums of Y, taken from the staged slabs on the
// CUDA cores in fp32.
//

#include "gated_hifi_tiles.cuh"

#include <vector>

namespace gated_hifi {
namespace {

// 4. du = gv Wg^T, then gv, u and dzp_d (from zp_d, in place), element by
// element: the softmax over branches of the s halves, tanh of the t halves
template <class IO>
__global__ void __launch_bounds__(NT, 2) tile_gate_kernel(const Args<IO> p) {
  TILE_PROLOGUE;
  float acc[TileShape<W>::MT][4][4] = {};
  gemm<W, false, IO, IO>(acc, smem, W / KS, t0, T, [&](int s) {
    return Slice<IO, IO>{p.g + row0 * W + KS * s, W, 0, p.wg_t + (size_t)KS * s * W, W};
  });
  const int len = min(T, p.lens[b]);
  const int depth = p.br.depth;
  for_pairs<W>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const bool valid = t < len;
    const float2 gg = ld2(p.g + (row0 + t) * W + c);
    st2(p.gv + (row0 + t) * W + c, valid ? p.scale * gg.x : 0.f, valid ? p.scale * gg.y : 0.f);
    const float du[2] = {valid ? p.scale * v0 : 0.f, valid ? p.scale * v1 : 0.f};
    float* zrow = p.dzp + (row0 + t) * ldw + c;
    Mix mx;
    mix(mx, zrow, depth);
    st2(p.u + (row0 + t) * W + c, mx.u[0], mx.u[1]);
#pragma unroll
    for (int dd = 0; dd < MAX_DEPTH; ++dd) {
      if (dd >= depth) break;
      const float tv[2] = {mx.tz[dd].x, mx.tz[dd].y}, sv[2] = {mx.sz[dd].x, mx.sz[dd].y};
      float dt[2], ds[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float th = tanhf(tv[j]);
        const float pj = expf(sv[j] - mx.m[j]) / mx.den[j];
        dt[j] = du[j] * pj * (1.f - th * th);
        ds[j] = du[j] * pj * (th - mx.u[j]);
      }
      st2(zrow + dd * H, dt[0], dt[1]);
      st2(zrow + dd * H + W, ds[0], ds[1]);
    }
  });
}

// 5. dc_d = scale * (dzp_d W1_d^T) * m1 * [c > 0]  (h1 > 0 exactly there)
template <class IO>
__global__ void __launch_bounds__(NT, 2) tile_dc_kernel(const Args<IO> p) {
  TILE_PROLOGUE;
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H, false, IO, float>(acc, smem, H / KS, t0, T, [&](int s) {
    return Slice<IO, float>{p.dzp + row0 * ldw + d * H + KS * s, ldw, 0,
                            p.w1_t + (size_t)d * H * H + (size_t)KS * s * H, H};
  });
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const size_t idx = (row0 + t) * ldw + d * H + c;
    const float2 h = ld2(p.h1 + idx);
    st2(p.dc + idx, h.x > 0.f ? p.scale * v0 * p.keep : 0.f, h.y > 0.f ? p.scale * v1 * p.keep : 0.f);
  });
}

// 6. dz_d = dzp_d + (sum_j dc_d[t - (j-half) dil] K_d[j]^T) * m0 * [z > 0]
// (a = relu(z) * m0 > 0 exactly there)
template <class IO>
__global__ void __launch_bounds__(NT, 2) tile_convt_kernel(const Args<IO> p) {
  TILE_PROLOGUE;
  const int k = p.br.k[d], dil = p.br.dil[d], half = (k - 1) / 2;
  const IO* kd = p.ks_t + p.br.k_off[d];
  float acc[TileShape<H>::MT][4][4] = {};
  gemm<H, false, IO, float>(acc, smem, k * (H / KS), t0, T, [&](int s) {
    const int j = s / (H / KS), c = s % (H / KS);
    return Slice<IO, float>{p.dc + row0 * ldw + d * H + KS * c, ldw, -(j - half) * dil,
                            kd + (size_t)j * H * H + (size_t)KS * c * H, H};
  });
  for_pairs<H>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const size_t idx = (row0 + t) * ldw + d * H + c;
    const float2 z = ld2(p.dzp + idx), av = ld2(p.a + idx);
    st2(p.dz + idx, z.x + (av.x > 0.f ? v0 * p.keep : 0.f), z.y + (av.y > 0.f ? v1 * p.keep : 0.f));
  });
}

// 7. dx = g * [t < len] + dz Wall^T
template <class IO>
__global__ void __launch_bounds__(NT, 2) tile_dx_kernel(const Args<IO> p) {
  TILE_PROLOGUE;
  float acc[TileShape<W>::MT][4][4] = {};
  gemm<W, false, IO, float>(acc, smem, ldw / KS, t0, T, [&](int s) {
    return Slice<IO, float>{p.dz + row0 * ldw + KS * s, ldw, 0, p.wall_t + (size_t)KS * s * W, W};
  });
  const int len = min(T, p.lens[b]);
  for_pairs<W>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    const float2 gg = t < len ? ld2(p.g + (row0 + t) * W + c) : make_float2(0.f, 0.f);
    st2(p.dx + (row0 + t) * W + c, v0 + gg.x, v1 + gg.y);
  });
}

#undef TILE_PROLOGUE

// ---- weight gradients: split-over-frames reduction on the tensor cores -----
constexpr int WG_TILE = 128 * 128;        // a partial's product tile: TM x (WG_TILE / TM), TM = 128 or 64
constexpr int WG_PART = WG_TILE + 256;    // a partial: the tile (fragment order) and its column sums
constexpr int WG_KF = 32;                 // frames per staged slab: four k-steps
constexpr int WG_STAGES = 2;              // slabs in flight (double buffering)
constexpr int WG_FLUSH = 32;              // slabs between two adds of the accumulators into the partial
constexpr int WG_MAX_PROBLEMS = 48;

// A slab's row strides (elements of X, floats of Y) for a tm-row tile:
// fragment reads on distinct banks
template <class IO>
__host__ __device__ constexpr int wg_ldxs(int tm) { return tm + 8; }
template <class IO>
__host__ __device__ constexpr int wg_ldys(int tm) { return WG_TILE / tm + 8; }
template <class IO>
__host__ __device__ constexpr int wg_stage_bytes(int tm) {
  return WG_KF * (wg_ldxs<IO>(tm) * (int)sizeof(IO) + wg_ldys<IO>(tm) * (int)sizeof(float));
}
template <class IO>
constexpr size_t WG_SMEM =
    (size_t)WG_STAGES * (wg_stage_bytes<IO>(64) > wg_stage_bytes<IO>(128) ? wg_stage_bytes<IO>(64)
                                                                          : wg_stage_bytes<IO>(128));

// out_w[m, n] = scale * sum_r X[r + shift, m] * Y[r, n] over the B*T frames r
// (X zero where t + shift leaves [0, T)); out_b[n] = scale * sum_r Y[r, n].
// M and N are multiples of 64, at most tm and WG_TILE / tm. X and the
// outputs are IO, Y fp32.
template <class IO>
struct WgradProblem {
  const IO* X;
  const float* Y;
  IO* out_w;
  IO* out_b;  // nullptr: no column sums
  int ldx, ldy, ldo, shift, M, N, tm;
  float scale;
};

template <class IO>
struct WgradBatch {
  WgradProblem<IO> p[WG_MAX_PROBLEMS];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <class IO>
__global__ void __launch_bounds__(NT, 2) wgrad_partial_kernel(
    const WgradBatch<IO> batch, int p0, float* __restrict__ partials, int B, int T, int n_split) {
  extern __shared__ __align__(16) float smem[];
  char* const sm = reinterpret_cast<char*>(smem);
  const WgradProblem<IO> pr = batch.p[blockIdx.y];
  const int tm = pr.tm, tn = WG_TILE / tm;
  const int ldxs = wg_ldxs<IO>(tm), ldys = wg_ldys<IO>(tm);  // slab row strides
  const int stage_bytes = wg_stage_bytes<IO>(tm);
  const long long rows = (long long)B * T;
  const long long chunk = (rows + n_split - 1) / n_split;
  const long long r_begin = (long long)blockIdx.x * chunk;
  const long long r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
  const int n_slabs = r_end > r_begin ? (int)((r_end - r_begin + WG_KF - 1) / WG_KF) : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps_m = tm / 32;
  const int wrow = (warp % warps_m) * 32, wcol = (warp / warps_m) * 64;  // the warp's 32 x 64
  const bool active = wrow < pr.M && wcol < pr.N;
  const int gr = lane >> 2, qd = lane & 3;
  const int col = threadIdx.x % tn;  // this thread's column of the column sums

  auto slab_x = [&](int slab) { return reinterpret_cast<IO*>(sm + (slab % WG_STAGES) * stage_bytes); };
  auto slab_y = [&](int slab) {
    return reinterpret_cast<float*>(sm + (slab % WG_STAGES) * stage_bytes + WG_KF * ldxs * sizeof(IO));
  };
  auto load = [&](int slab) {
    IO* xs = slab_x(slab);
    float* ys = slab_y(slab);
    const long long r0 = r_begin + (long long)slab * WG_KF;
    constexpr int EX = 16 / sizeof(IO);
    const int xq = pr.M / EX, yq = pr.N / 4;  // 16-byte copies per frame
    for (int f = threadIdx.x; f < WG_KF * xq; f += NT) {
      const int rr = f / xq, c = f % xq;
      const long long r = r0 + rr;
      const int ts = (int)(r % T) + pr.shift;
      const bool in = r < r_end && ts >= 0 && ts < T;
      tf32::cp_async16(xs + rr * ldxs + EX * c, in ? pr.X + (r + pr.shift) * pr.ldx + EX * c : pr.X,
                       in ? 16 : 0);
    }
    for (int f = threadIdx.x; f < WG_KF * yq; f += NT) {
      const int rr = f / yq, c4 = f % yq;
      const long long r = r0 + rr;
      const bool in = r < r_end;
      tf32::cp_async16(ys + rr * ldys + 4 * c4, in ? pr.Y + r * pr.ldy + 4 * c4 : pr.Y, in ? 16 : 0);
    }
  };

  // this thread's accumulator pairs in the partial: (mt, nt, h) at
  // ((mt * 8 + nt) * 2 + h) * 64 floats from here, a warp's 32 lanes side by side
  float* frag = partials + ((size_t)(p0 + blockIdx.y) * n_split + blockIdx.x) * WG_PART + warp * 2048 + 2 * lane;
  float acc[2][8][4] = {};
  auto flush = [&](bool first) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* q = reinterpret_cast<float2*>(frag + ((mt * 8 + nt) * 2 + h) * 64);
          float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          if (!first) {
            const float2 o = *q;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *q = v;
          acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
        }
  };
  float colsum = 0.f;
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < n_slabs) load(s);
    tf32::cp_async_commit();
  }
  for (int s = 0; s < n_slabs; ++s) {
    tf32::cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // slab s has landed, and every warp is done with slab s - 1
    if (s + WG_STAGES - 1 < n_slabs) load(s + WG_STAGES - 1);
    tf32::cp_async_commit();
    const IO* xs = slab_x(s);
    const float* ys = slab_y(s);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < WG_KF / 8; ++kk) {
        // A (m, k) = X[frame k, channel m]: rows of the slab are frames
        tf32::FragA fa[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* q = xs + (8 * kk + qd) * ldxs + wrow + 16 * mt + gr;
          fa[mt] = tf32::frag_a(q[0], q[8], q[4 * ldxs], q[4 * ldxs + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* c = ys + (8 * kk + qd) * ldys + wcol + 8 * nt + gr;
          const tf32::FragB fb = tf32::frag_b(c[0], c[4 * ldys]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) tf32::mma3(acc[mt][nt], fa[mt], fb);
        }
      }
      if ((s + 1) % WG_FLUSH == 0 || s + 1 == n_slabs) flush(s < WG_FLUSH);
    }
    if (pr.out_b != nullptr && col < pr.N)
      for (int rr = threadIdx.x / tn; rr < WG_KF; rr += NT / tn) colsum += ys[rr * ldys + col];
  }
  tf32::cp_async_wait<0>();
  __syncthreads();  // the staging buffers are free: the column sums' halves meet there

  if (active && n_slabs == 0) flush(true);  // an empty slice: zeros
  if (pr.out_b != nullptr) {
    smem[threadIdx.x] = colsum;
    __syncthreads();
    if (threadIdx.x < tn) {
      float sum = 0.f;
      for (int h = threadIdx.x; h < NT; h += tn) sum += smem[h];  // fixed order
      partials[((size_t)(p0 + blockIdx.y) * n_split + blockIdx.x) * WG_PART + WG_TILE + threadIdx.x] = sum;
    }
  }
}

// the sums in fp32, each stored once in IO
template <class IO>
__global__ void __launch_bounds__(NT) wgrad_reduce_kernel(
    const WgradBatch<IO> batch, int p0, const float* __restrict__ partials, int n_split) {
  const WgradProblem<IO> pr = batch.p[blockIdx.y];
  const int tn = WG_TILE / pr.tm;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= WG_TILE + tn) return;
  const int m = e / tn, n = e % tn;  // m == tm: the column sums
  if (n >= pr.N || (m < pr.tm && m >= pr.M) || (m == pr.tm && pr.out_b == nullptr)) return;
  int at = e;  // where the partial keeps (m, n): the accumulator layout of wgrad_partial_kernel
  if (m < pr.tm) {
    const int warp = m / 32 + (pr.tm / 32) * (n / 64), r = m % 32, c = n % 64;
    const int lane = (r % 8) * 4 + (c % 8) / 2;
    at = ((((warp * 2 + r / 16) * 8 + c / 8) * 2 + (r % 16) / 8) * 32 + lane) * 2 + c % 2;
  }
  const float* src = partials + (size_t)(p0 + blockIdx.y) * n_split * WG_PART + at;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += src[(size_t)s * WG_PART];  // fixed order
  sum *= pr.scale;
  if (m == pr.tm)
    store(pr.out_b + n, sum);
  else
    store(pr.out_w + (size_t)m * pr.ldo + n, sum);
}

int wgrad_problem_count(const Branches& br) {
  int taps = 0;
  for (int d = 0; d < br.depth; ++d) taps += br.k[d];
  // conv taps, branch 1x1s, gate, the expand in 256-column pieces
  return taps + br.depth + 1 + (br.depth * H + 255) / 256;
}

template <class IO>
int backward(const IO* x, const int* lens, const IO* g, const IO* wall, const IO* ball, const IO* ks,
             const IO* cb, const IO* w1, const IO* b1, const IO* wg_t, const IO* w1_t, const IO* ks_t,
             const IO* wall_t, IO* a, IO* h1, float* dzp, float* dc, float* dz, IO* u, float* gv, IO* dx,
             int B, int T, int width, int depth, const int* kernels, const int* dilations, float scale,
             unsigned seed, unsigned threshold, float keep_scale, void* stream) {
  Branches br;
  if (width != W || B < 1 || B > 65535 || T < 1 || !make_branches(depth, kernels, dilations, &br))
    return (int)cudaErrorInvalidValue;
  Args<IO> p{};
  p.br = br;
  p.x = x;
  p.g = g;
  p.lens = lens;
  p.wall = wall;
  p.ball = ball;
  p.ks = ks;
  p.cb = cb;
  p.w1 = w1;
  p.b1 = b1;
  p.wg_t = wg_t;
  p.w1_t = w1_t;
  p.ks_t = ks_t;
  p.wall_t = wall_t;
  p.a = a;
  p.h1 = h1;
  p.dzp = dzp;
  p.dc = dc;
  p.dz = dz;
  p.u = u;
  p.gv = gv;
  p.dx = dx;
  p.T = T;
  p.scale = scale;
  p.keep = threshold ? keep_scale : 1.f;
  p.drop = Dropout{seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr size_t wide = Staging<H, IO, IO>::SMEM, narrow = Staging<W, IO, IO>::SMEM;
  constexpr size_t wide_f = Staging<H, IO, float>::SMEM, narrow_f = Staging<W, IO, float>::SMEM;
  // in stream order: each stage reads what the ones before it wrote
  cudaError_t err = launch_stage(tile_expand_kernel<false, IO>, wide, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage(tile_conv_kernel<false, IO>, wide, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage(tile_branch_kernel<false, IO>, wide, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage(tile_gate_kernel<IO>, narrow, p, B, 1, s);
  if (err == cudaSuccess) err = launch_stage(tile_dc_kernel<IO>, wide_f, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage(tile_convt_kernel<IO>, wide_f, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage(tile_dx_kernel<IO>, narrow_f, p, B, 1, s);
  return (int)err;
}

template <class IO>
int wgrad_splits(long long rows, int depth, const int* kernels) {
  static int slots = 0;  // SMs x resident blocks, queried once
  std::vector<int> dil(depth > 0 ? depth : 1, 1);
  Branches br;
  if (!make_branches(depth, kernels, dil.data(), &br) || rows < 1) return -1;
  if (slots == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return -1;
    const int per_sm = blocks_per_sm((const void*)wgrad_partial_kernel<IO>, NT, WG_SMEM<IO>);
    if (per_sm < 1) return -1;
    slots = sms * per_sm;
  }
  const int problems = wgrad_problem_count(br);
  const long long n = (rows + 1023) / 1024 < 64 ? (rows + 1023) / 1024 : 64;
  const long long waves = (problems * n + slots - 1) / slots;
  const long long fill = waves * slots / problems;
  return (int)(fill < 1 ? 1 : fill < rows ? fill : rows);
}

template <class IO>
int wgrad(const IO* x, const IO* a, const IO* h1, const float* dzp, const float* dc, const float* dz, const IO* u,
          const float* gv, float* partials, IO* grads, int B, int T, int width, int depth, const int* kernels,
          const int* dilations, float scale, int n_split, void* stream) {
  Branches br;
  if (width != W || B < 1 || T < 1 || n_split < 1 || !make_branches(depth, kernels, dilations, &br))
    return (int)cudaErrorInvalidValue;
  const int ldb = depth * H;
  int taps = 0;
  for (int d = 0; d < depth; ++d) taps += br.k[d];
  IO* dwall = grads;
  IO* dball = dwall + W * ldb;
  IO* dks = dball + ldb;
  IO* dcb = dks + (size_t)taps * H * H;
  IO* dw1 = dcb + ldb;
  IO* db1 = dw1 + (size_t)depth * H * H;
  IO* dwg = db1 + ldb;
  IO* dbg = dwg + W * W;

  std::vector<WgradProblem<IO>> probs;
  for (int d = 0; d < depth; ++d) {
    const int half = (br.k[d] - 1) / 2;
    for (int j = 0; j < br.k[d]; ++j)
      probs.push_back({a + d * H, dc + d * H, dks + br.k_off[d] + (size_t)j * H * H,
                       j == 0 ? dcb + d * H : nullptr, ldb, ldb, H, (j - half) * br.dil[d], H, H, 128,
                       1.f});
  }
  for (int d = 0; d < depth; ++d)
    probs.push_back({h1 + d * H, dzp + d * H, dw1 + (size_t)d * H * H, db1 + d * H, ldb, ldb, H,
                     0, H, H, 128, scale});
  probs.push_back({u, gv, dwg, dbg, W, W, W, 0, W, W, 64, 1.f});
  for (int c0 = 0; c0 < ldb; c0 += 256)  // x^T dz in 64 x 256 tiles
    probs.push_back({x, dz + c0, dwall + c0, dball + c0, W, ldb, ldb, 0, W,
                     ldb - c0 < 256 ? ldb - c0 : 256, 64, 1.f});

  const size_t smem = WG_SMEM<IO>;
  cudaError_t err = cudaFuncSetAttribute(wgrad_partial_kernel<IO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int p0 = 0; p0 < (int)probs.size(); p0 += WG_MAX_PROBLEMS) {
    const int left = (int)probs.size() - p0;
    const int n = left < WG_MAX_PROBLEMS ? left : WG_MAX_PROBLEMS;
    WgradBatch<IO> batch{};
    for (int i = 0; i < n; ++i) batch.p[i] = probs[p0 + i];
    wgrad_partial_kernel<IO><<<dim3(n_split, n), NT, smem, s>>>(batch, p0, partials, B, T, n_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wgrad_reduce_kernel<IO><<<dim3((WG_PART + NT - 1) / NT, n), NT, 0, s>>>(batch, p0, partials, n_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <class IO>
int backward_blocks_per_sm(int* blocks) {
  const StageKernel<IO> stages[7] = {tile_expand_kernel<false, IO>, tile_conv_kernel<false, IO>,
                                     tile_branch_kernel<false, IO>, tile_gate_kernel<IO>,
                                     tile_dc_kernel<IO>, tile_convt_kernel<IO>, tile_dx_kernel<IO>};
  const size_t stage_smem[7] = {Staging<H, IO, IO>::SMEM, Staging<H, IO, IO>::SMEM, Staging<H, IO, IO>::SMEM,
                                Staging<W, IO, IO>::SMEM, Staging<H, IO, float>::SMEM,
                                Staging<H, IO, float>::SMEM, Staging<W, IO, float>::SMEM};
  for (int i = 0; i < 7; ++i) blocks[i] = blocks_per_sm((const void*)stages[i], NT, stage_smem[i]);
  blocks[7] = blocks_per_sm((const void*)wgrad_partial_kernel<IO>, NT, WG_SMEM<IO>);
  blocks[8] = blocks_per_sm((const void*)wgrad_reduce_kernel<IO>, NT, 0);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gated_hifi

// Launches the tile passes' seven stages on `stream`; returns a cudaError_t
// (0 on success). Inputs as for gated_hifi_fwd, plus g [B, T, width] (the
// output's cotangent) and the transposed weights: wg_t [W(out), W(in)], w1_t
// [depth, H(out), H(in)], ks_t the branches' [k_d, H(out), H(in)] back to
// back, wall_t [depth*H, W]. Outputs: a, h1, dzp, dc, dz [B, T, depth*H];
// u, gv, dx [B, T, width].
extern "C" int gated_hifi_bwd(const float* x, const int* lens, const float* g, const float* wall,
                              const float* ball, const float* ks, const float* cb, const float* w1,
                              const float* b1, const float* wg_t, const float* w1_t,
                              const float* ks_t, const float* wall_t, float* a, float* h1,
                              float* dzp, float* dc, float* dz, float* u, float* gv, float* dx,
                              int B, int T, int width, int depth, const int* kernels,
                              const int* dilations, float scale, unsigned seed,
                              unsigned threshold, float keep_scale, void* stream) {
  return gated_hifi::backward<float>(x, lens, g, wall, ball, ks, cb, w1, b1, wg_t, w1_t, ks_t, wall_t, a, h1, dzp,
                                     dc, dz, u, gv, dx, B, T, width, depth, kernels, dilations, scale, seed,
                                     threshold, keep_scale, stream);
}

// Slices of the B*T frames gated_hifi_wgrad sums apart: one per 1,024
// frames, at most 64, then as many as fill the same number of waves of the
// card's resident wgrad_partial_kernel blocks (the blocks are problems x
// slices: 31 x 9 = 279 for 264 slots left a second wave of 15 at 16 x 516
// frames). Returns -1 on an invalid branch table or a failed device query.
extern "C" int gated_hifi_wgrad_splits(long long rows, int depth, const int* kernels) {
  return gated_hifi::wgrad_splits<float>(rows, depth, kernels);
}

// Floats of the partials buffer gated_hifi_wgrad needs.
extern "C" long gated_hifi_wgrad_partial_floats(int depth, const int* kernels, int n_split) {
  using namespace gated_hifi;
  std::vector<int> dil(depth > 0 ? depth : 1, 1);
  Branches br;
  if (!make_branches(depth, kernels, dil.data(), &br) || n_split < 1) return -1;
  return (long)wgrad_problem_count(br) * n_split * WG_PART;
}

// Weight gradients from the tile passes' buffers, into `grads`: the packed
// layout wall | ball | ks | cb | w1 | b1 | wg | bg of gated_hifi_fwd's
// weights. Each gradient is split over n_split slices of the B*T frames
// into `partials`, then summed in slice order.
extern "C" int gated_hifi_wgrad(const float* x, const float* a, const float* h1, const float* dzp,
                                const float* dc, const float* dz, const float* u, const float* gv,
                                float* partials, float* grads, int B, int T, int width, int depth,
                                const int* kernels, const int* dilations, float scale,
                                int n_split, void* stream) {
  return gated_hifi::wgrad<float>(x, a, h1, dzp, dc, dz, u, gv, partials, grads, B, T, width, depth, kernels,
                                  dilations, scale, n_split, stream);
}

// Resident blocks per SM of the backward's kernels, in launch order (the
// seven tile stages, then wgrad_partial_kernel, wgrad_reduce_kernel), into
// blocks[0..8]; returns a cudaError_t.
extern "C" int gated_hifi_bwd_blocks_per_sm(int* blocks) { return gated_hifi::backward_blocks_per_sm<float>(blocks); }
