// GatedHiFi block backward for Hopper (sm_90a), fp32, with the dropout
// masks regenerated from the seed.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/gated_hifi.py, function
// _vjp_bwd -> _bwd -> _bwd_kernel (the TPU kernel's recompute backward).
// Like it, this saves no residuals beyond x, lens, the weights and the
// seed: the forward is recomputed from x. What it computes, with the
// forward's names (gated_hifi_fwd.cu) and g the output's cotangent:
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
//     would make that window 64 + 432 = 496 frames here, 254 KB for the
//     a-window of one branch alone, over the 227 KB a block may have. So
//     the backward is split into passes that meet in device memory:
//       pass A (bwd_recompute_kernel), per 64-frame tile and sequence:
//         the forward's recompute over centre +- halo (the forward kernel's
//         tiling and shared memory), then the gating backward and
//         dc_d = scale (dzp_d W1_d^T) m1 [c > 0]. Writes a_d, h1_d, dzp_d
//         and dc_d ([B, T, depth*H] each, 270 MB per branch at 16 x 33024),
//         u and gv ([B, T, W]).
//       pass B (bwd_transpose_kernel), per tile and sequence: the
//         transposed dilated conv over the dc window centre +- halo, then
//         dz_d (written, [B, T, depth*H]) and dx = g' + dz Wall^T.
//  2. Its weight gradients. The TPU accumulates them across its sequential
//     grid (@pl.when(first) ... += ...). Hopper's blocks run in parallel
//     and in no order, so every weight gradient is a product summed over
//     the B*T frames, computed as a split-over-time reduction: each block of
//     wgrad_partial_kernel sums one slice of the frames for one product
//     (one conv tap of one branch, a branch 1x1, the gate, or a branch's
//     slice of the expand) into its own partial, and wgrad_reduce_kernel
//     adds the slices in a fixed order. No float atomics: equal inputs give
//     bitwise-equal gradients.
//
// What bounds it: arithmetic, as in the forward. The JAX cost model puts
// the backward at 3x the forward's FLOPs; here pass A costs a forward plus
// the 1x1 transposes, pass B the transposed convs (about a forward), and
// the weight gradients about the convs' share again. Device-memory traffic
// is about 10 GB per call at 16 x 33024, a few ms at 3.35 TB/s. Products are
// plain fp32 FMA on the CUDA cores, tiled as in the forward kernel (4 rows x
// 8 columns a thread, channel loops unrolled 8 deep); the reduction tiles
// are 128 x 128 with 8 x 8 a thread over 16-frame slabs in shared memory.

#include "gated_hifi_common.cuh"

#include <math.h>

#include <vector>

namespace gated_hifi {
namespace {

__device__ __forceinline__ float4 ld4v(const float* p) {  // plain load: p may be written here
  return *reinterpret_cast<const float4*>(p);
}

// dst[r][c] (row stride AS) = src[b, tstart + r, col0 + c] for r < rows, c < H,
// zero where tstart + r is outside [0, T). src rows are ld floats; row0 = b*T.
// Each thread issues 8 loads before it stores any, so 8 are in flight.
__device__ __forceinline__ void load_window(float* dst, const float* src, size_t row0, int ld,
                                            int col0, int tstart, int rows, int T) {
  constexpr int U = 8;
  const int n = rows * H;
  for (int i0 = threadIdx.x; i0 < n; i0 += NT * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      const int t = tstart + i / H;
      v[u] = (i < n && t >= 0 && t < T) ? src[(row0 + t) * ld + col0 + i % H] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      if (i < n) dst[(i / H) * AS + i % H] = v[u];
    }
  }
}

template <bool DROP>
__global__ void __launch_bounds__(NT, 1) bwd_recompute_kernel(
    const float* __restrict__ x, const int* __restrict__ lens, const float* __restrict__ g,
    const float* __restrict__ wall, const float* __restrict__ ball,
    const float* __restrict__ ks, const float* __restrict__ cb,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ wg_t, const float* __restrict__ w1_t,
    float* __restrict__ a_out, float* __restrict__ h1_out, float* __restrict__ dzp,
    float* __restrict__ dc_out, float* __restrict__ u_out, float* __restrict__ gv_out,
    int T, float scale, Branches br, Dropout drop) {
  extern __shared__ float smem[];
  const int R = TT + 2 * br.max_halo;
  float* xs = smem;          // [R][XS]  x window, zero outside [0, T)
  float* as = xs + R * XS;   // [R][AS]  gv, then per branch relu(expand)*m0 and
                             //          h1; at the end dzp_d

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane & 15;             // this thread's rows: rg + 16*i, i < 4
  const int cg = lane >> 4;
  const int n8 = warp * 16 + cg * 8;    // its 8 columns of H
  const int n4 = warp * 8 + cg * 4;     // its 4 columns of W
  const int ldw = br.depth * H;         // row stride of wall and of the [B, T, depth*H] buffers
  const size_t row0 = (size_t)b * T;
  const float* xb = x + row0 * W;
  const int len = min(T, lens[b]);

  for (int i = tid; i < R * W; i += NT) {
    const int r = i / W, c = i % W;
    const int t = t0 - br.max_halo + r;
    xs[r * XS + c] = (t >= 0 && t < T) ? xb[(size_t)t * W + c] : 0.f;
  }
  // gv = scale * g, zero past the length, at the centre rows
  for (int i = tid; i < TT * W; i += NT) {
    const int r = i / W, c = i % W;
    const int t = t0 + r;
    const float v = t < len ? scale * g[(row0 + t) * W + c] : 0.f;
    as[r * AS + c] = v;
    if (t < T) gv_out[(row0 + t) * W + c] = v;
  }
  __syncthreads();

  // du = gv Wg^T at (row rg+16i, column n4+j)
  float du[4][4] = {};
#pragma unroll 8
  for (int c = 0; c < W; ++c) {
    const float4 wv = ld4(wg_t + (size_t)c * W + n4);
#pragma unroll
    for (int i = 0; i < 4; ++i) fma4(du[i], as[(rg + 16 * i) * AS + c], wv);
  }
  __syncthreads();

  float m_run[4][4], den[4][4], num[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m_run[i][j] = -INFINITY;
      den[i][j] = 0.f;
      num[i][j] = 0.f;
    }

  // ---- recompute, as the forward kernel does; keep a, h1 and zp ----------
  for (int d = 0; d < br.depth; ++d) {
    const int k = br.k[d], dil = br.dil[d];
    const int halo = (k - 1) / 2 * dil;
    const uint32_t key = DROP ? dropout_key(drop.seed, b, d) : 0u;

    expand_tile<DROP>(as, xs, wall, ball, d, ldw, TT + 2 * halo, br.max_halo - halo, t0 - halo,
                      halo, T, key, drop, rg, n8, a_out + row0 * ldw + d * H + n8);
    __syncthreads();

    {
      float acc[4][8] = {};
      conv_tile(acc, as, ks + br.k_off[d] + n8, k, rg, dil);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + rg + 16 * i;
        float h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          h[j] = fmaxf(acc[i][j] + cb[d * H + n8 + j], 0.f);
          if (DROP)
            h[j] *= (dropout_bits(key, t, n8 + j) & 0xFFFFu) >= drop.threshold ? drop.scale : 0.f;
          as[(rg + 16 * i) * AS + n8 + j] = h[j];
        }
        if (t < T) {
          float* dst = h1_out + (row0 + t) * ldw + d * H + n8;
          st4(dst, h[0], h[1], h[2], h[3]);
          st4(dst + 4, h[4], h[5], h[6], h[7]);
        }
      }
    }
    __syncthreads();

    {
      float tv[4][4], sv[4][4];
      branch_out_tile(tv, sv, as, xs, wall, ball, w1, b1, d, ldw, br.max_halo, scale, rg, n4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float m_new = fmaxf(m_run[i][j], sv[i][j]);
          const float corr = expf(m_run[i][j] - m_new);
          const float e = expf(sv[i][j] - m_new);
          den[i][j] = den[i][j] * corr + e;
          num[i][j] = num[i][j] * corr + tanhf(tv[i][j]) * e;
          m_run[i][j] = m_new;
        }
        if (t < T) {  // zp, turned into its cotangent once every branch is in
          float* dst = dzp + (row0 + t) * ldw + d * H + n4;
          st4(dst, tv[i][0], tv[i][1], tv[i][2], tv[i][3]);
          st4(dst + W, sv[i][0], sv[i][1], sv[i][2], sv[i][3]);
        }
      }
    }
    __syncthreads();
  }

  // ---- gating backward: zp_d -> dzp_d, element by element ---------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + rg + 16 * i;
    if (t >= T) continue;
    float u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = num[i][j] / den[i][j];
    st4(u_out + (row0 + t) * W + n4, u[0], u[1], u[2], u[3]);
    for (int d = 0; d < br.depth; ++d) {
      float* pt = dzp + (row0 + t) * ldw + d * H + n4;
      const float4 t4 = ld4v(pt), s4 = ld4v(pt + W);
      const float tz[4] = {t4.x, t4.y, t4.z, t4.w}, sz[4] = {s4.x, s4.y, s4.z, s4.w};
      float dt[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float th = tanhf(tz[j]);
        const float p = expf(sz[j] - m_run[i][j]) / den[i][j];
        dt[j] = du[i][j] * p * (1.f - th * th);
        ds[j] = du[i][j] * p * (th - u[j]);
      }
      st4(pt, dt[0], dt[1], dt[2], dt[3]);
      st4(pt + W, ds[0], ds[1], ds[2], ds[3]);
    }
  }
  __syncthreads();  // dzp of the whole tile is in device memory

  // ---- dc_d = scale * (dzp_d W1_d^T) * m1 * [c > 0] ------------------------
  const float keep = DROP ? drop.scale : 1.f;
  for (int d = 0; d < br.depth; ++d) {
    load_window(as, dzp, row0, ldw, d * H, t0, TT, T);
    __syncthreads();
    float acc[4][8] = {};
    const float* wt = w1_t + (size_t)d * H * H + n8;
#pragma unroll 8
    for (int c = 0; c < H; ++c) {
      const float4 w0 = ld4(wt + (size_t)c * H), w1v = ld4(wt + (size_t)c * H + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) fma8(acc[i], as[(rg + 16 * i) * AS + c], w0, w1v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + rg + 16 * i;
      if (t >= T) continue;
      const size_t idx = (row0 + t) * ldw + d * H + n8;
      const float4 h0 = ld4v(h1_out + idx), h4 = ld4v(h1_out + idx + 4);
      const float h[8] = {h0.x, h0.y, h0.z, h0.w, h4.x, h4.y, h4.z, h4.w};
      float dc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)  // h1 = relu(c) * m1 > 0 exactly where c > 0 and kept
        dc[j] = h[j] > 0.f ? scale * acc[i][j] * keep : 0.f;
      st4(dc_out + idx, dc[0], dc[1], dc[2], dc[3]);
      st4(dc_out + idx + 4, dc[4], dc[5], dc[6], dc[7]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT, 1) bwd_transpose_kernel(
    const int* __restrict__ lens, const float* __restrict__ g,
    const float* __restrict__ ks_t, const float* __restrict__ wall_t,
    const float* __restrict__ a_in, const float* __restrict__ dzp,
    const float* __restrict__ dc_in, float* __restrict__ dz_out, float* __restrict__ dx,
    int T, float keep, Branches br) {
  extern __shared__ float smem[];
  float* as = smem;  // [TT + 2*max_halo][AS]  dc window, then dz at rows [0, TT)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane & 15;
  const int cg = lane >> 4;
  const int n8 = warp * 16 + cg * 8;
  const int n4 = warp * 8 + cg * 4;
  const int ldw = br.depth * H;
  const size_t row0 = (size_t)b * T;

  float dxa[4][4] = {};
  for (int d = 0; d < br.depth; ++d) {
    const int k = br.k[d], dil = br.dil[d];
    const int half = (k - 1) / 2;
    const int halo = half * dil;
    load_window(as, dc_in, row0, ldw, d * H, t0 - halo, TT + 2 * halo, T);
    __syncthreads();

    // da[t] = sum_j dc[t - (j-half)*dil] K_d[j]^T at the centre rows
    float acc[4][8] = {};
    conv_tile(acc, as, ks_t + br.k_off[d] + n8, k, rg + 2 * halo, -dil);
    __syncthreads();  // the dc window is read; rows [0, TT) take dz

    // dz = dzp + da * m0 * [z > 0] (a = relu(z) * m0 > 0 exactly there)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + rg + 16 * i;
      float v[8] = {};
      if (t < T) {
        const size_t idx = (row0 + t) * ldw + d * H + n8;
        const float4 z0 = ld4(dzp + idx), z4 = ld4(dzp + idx + 4);
        const float4 a0 = ld4(a_in + idx), a4 = ld4(a_in + idx + 4);
        const float z[8] = {z0.x, z0.y, z0.z, z0.w, z4.x, z4.y, z4.z, z4.w};
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = z[j] + (a[j] > 0.f ? acc[i][j] * keep : 0.f);
        st4(dz_out + idx, v[0], v[1], v[2], v[3]);
        st4(dz_out + idx + 4, v[4], v[5], v[6], v[7]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) as[(rg + 16 * i) * AS + n8 + j] = v[j];
    }
    __syncthreads();

    // dx += dz_d Wall_d^T
    const float* wt = wall_t + (size_t)d * H * W + n4;
#pragma unroll 8
    for (int c = 0; c < H; ++c) {
      const float4 wv = ld4(wt + (size_t)c * W);
#pragma unroll
      for (int i = 0; i < 4; ++i) fma4(dxa[i], as[(rg + 16 * i) * AS + c], wv);
    }
    __syncthreads();
  }

  const int len = min(T, lens[b]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + rg + 16 * i;
    if (t >= T) continue;
    const float* gr = g + (row0 + t) * W + n4;
    const bool valid = t < len;
    float4 o;
    o.x = dxa[i][0] + (valid ? gr[0] : 0.f);
    o.y = dxa[i][1] + (valid ? gr[1] : 0.f);
    o.z = dxa[i][2] + (valid ? gr[2] : 0.f);
    o.w = dxa[i][3] + (valid ? gr[3] : 0.f);
    *reinterpret_cast<float4*>(dx + (row0 + t) * W + n4) = o;
  }
}

// ---- weight gradients: split-over-time reduction ---------------------------
constexpr int WG_TILE = 128;       // out tile: M, N <= 128
constexpr int WG_ROWS = 16;        // frames per shared-memory slab
constexpr int WG_PART = (WG_TILE + 1) * WG_TILE;  // a partial: the tile and its column sums
constexpr int WG_MAX_PROBLEMS = 48;

// out_w[m, n] (+)= scale * sum_r X[r + shift, m] * Y[r, n] over the B*T frames r
// (X zero where t + shift leaves [0, T)); out_b[n] = scale * sum_r Y[r, n].
struct WgradProblem {
  const float* X;
  const float* Y;
  float* out_w;
  float* out_b;  // nullptr: no column sums
  int ldx, ldy, ldo, shift, M, N;
  float scale;
};

struct WgradBatch {
  WgradProblem p[WG_MAX_PROBLEMS];
};

__global__ void __launch_bounds__(NT) wgrad_partial_kernel(
    const WgradBatch batch, int p0, float* __restrict__ partials, int B, int T, int n_split) {
  __shared__ __align__(16) float xsl[WG_ROWS][WG_TILE];
  __shared__ __align__(16) float ysl[WG_ROWS][WG_TILE];
  const WgradProblem pr = batch.p[blockIdx.y];
  const int s = blockIdx.x;
  const long long rows = (long long)B * T;
  const long long chunk = (rows + n_split - 1) / n_split;
  const long long r_begin = s * chunk;
  const long long r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4 (+64), columns tx*4 (+64) of the tile

  float acc[8][8] = {};
  float colsum = 0.f;  // column tid's sum of Y, tid < WG_TILE
  for (long long r0 = r_begin; r0 < r_end; r0 += WG_ROWS) {
    for (int q = tid; q < WG_ROWS * WG_TILE / 4; q += NT) {
      const int rr = q / (WG_TILE / 4), c4 = (q % (WG_TILE / 4)) * 4;
      const long long r = r0 + rr;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
      if (r < r_end) {
        const int ts = (int)(r % T) + pr.shift;
        if (c4 < pr.N) yv = *reinterpret_cast<const float4*>(pr.Y + r * pr.ldy + c4);
        if (c4 < pr.M && ts >= 0 && ts < T)
          xv = *reinterpret_cast<const float4*>(pr.X + (r + pr.shift) * pr.ldx + c4);
      }
      *reinterpret_cast<float4*>(&xsl[rr][c4]) = xv;
      *reinterpret_cast<float4*>(&ysl[rr][c4]) = yv;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < WG_ROWS; ++rr) {
      const float4 xa = *reinterpret_cast<const float4*>(&xsl[rr][ty * 4]);
      const float4 xb = *reinterpret_cast<const float4*>(&xsl[rr][64 + ty * 4]);
      const float4 ya = *reinterpret_cast<const float4*>(&ysl[rr][tx * 4]);
      const float4 yb = *reinterpret_cast<const float4*>(&ysl[rr][64 + tx * 4]);
      const float xm[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float yn[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xm[i], yn[j], acc[i][j]);
      if (tid < WG_TILE) colsum += ysl[rr][tid];
    }
    __syncthreads();
  }

  float* out = partials + ((size_t)(p0 + blockIdx.y) * n_split + s) * WG_PART;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    *reinterpret_cast<float4*>(out + m * WG_TILE + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + m * WG_TILE + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (tid < WG_TILE) out[WG_TILE * WG_TILE + tid] = colsum;
}

__global__ void __launch_bounds__(NT) wgrad_reduce_kernel(
    const WgradBatch batch, int p0, const float* __restrict__ partials, int n_split) {
  const WgradProblem pr = batch.p[blockIdx.y];
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= WG_PART) return;
  const int m = e / WG_TILE, n = e % WG_TILE;
  if (n >= pr.N || (m < WG_TILE && m >= pr.M) || (m == WG_TILE && pr.out_b == nullptr)) return;
  const float* src = partials + (size_t)(p0 + blockIdx.y) * n_split * WG_PART + e;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += src[(size_t)s * WG_PART];  // fixed order
  sum *= pr.scale;
  if (m == WG_TILE)
    pr.out_b[n] = sum;
  else
    pr.out_w[(size_t)m * pr.ldo + n] = sum;
}

int wgrad_problem_count(const Branches& br) {
  int taps = 0;
  for (int d = 0; d < br.depth; ++d) taps += br.k[d];
  return taps + 2 * br.depth + 1;  // conv taps, branch 1x1s, gate, expand slices
}

}  // namespace
}  // namespace gated_hifi

// Launches the two tile passes on `stream`; returns a cudaError_t (0 on
// success). Inputs as for gated_hifi_fwd, plus g [B, T, width] (the output's
// cotangent) and the transposed weights: wg_t [W(out), W(in)], w1_t
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
  using namespace gated_hifi;
  Branches br;
  if (width != W || B < 1 || T < 1 || !make_branches(depth, kernels, dilations, &br))
    return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + TT - 1) / TT, B);

  const size_t smem_a = tile_smem_bytes(br.max_halo);
  cudaError_t err;
  if (threshold) {
    err = cudaFuncSetAttribute(bwd_recompute_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    if (err != cudaSuccess) return (int)err;
    bwd_recompute_kernel<true><<<grid, NT, smem_a, s>>>(x, lens, g, wall, ball, ks, cb, w1, b1,
                                                        wg_t, w1_t, a, h1, dzp, dc, u, gv, T,
                                                        scale, br, drop);
  } else {
    err = cudaFuncSetAttribute(bwd_recompute_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    if (err != cudaSuccess) return (int)err;
    bwd_recompute_kernel<false><<<grid, NT, smem_a, s>>>(x, lens, g, wall, ball, ks, cb, w1, b1,
                                                         wg_t, w1_t, a, h1, dzp, dc, u, gv, T,
                                                         scale, br, drop);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_b = sizeof(float) * (TT + 2 * (size_t)br.max_halo) * AS;
  err = cudaFuncSetAttribute(bwd_transpose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  bwd_transpose_kernel<<<grid, NT, smem_b, s>>>(lens, g, ks_t, wall_t, a, dzp, dc, dz, dx, T,
                                                threshold ? keep_scale : 1.f, br);
  return (int)cudaGetLastError();
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
  using namespace gated_hifi;
  Branches br;
  if (width != W || B < 1 || T < 1 || n_split < 1 || !make_branches(depth, kernels, dilations, &br))
    return (int)cudaErrorInvalidValue;
  const int ldb = depth * H;
  int taps = 0;
  for (int d = 0; d < depth; ++d) taps += br.k[d];
  float* dwall = grads;
  float* dball = dwall + W * ldb;
  float* dks = dball + ldb;
  float* dcb = dks + (size_t)taps * H * H;
  float* dw1 = dcb + ldb;
  float* db1 = dw1 + (size_t)depth * H * H;
  float* dwg = db1 + ldb;
  float* dbg = dwg + W * W;

  std::vector<WgradProblem> probs;
  for (int d = 0; d < depth; ++d) {
    const int half = (br.k[d] - 1) / 2;
    for (int j = 0; j < br.k[d]; ++j)
      probs.push_back({a + d * H, dc + d * H, dks + br.k_off[d] + (size_t)j * H * H,
                       j == 0 ? dcb + d * H : nullptr, ldb, ldb, H, (j - half) * br.dil[d], H, H,
                       1.f});
  }
  for (int d = 0; d < depth; ++d)
    probs.push_back({h1 + d * H, dzp + d * H, dw1 + (size_t)d * H * H, db1 + d * H, ldb, ldb, H,
                     0, H, H, scale});
  probs.push_back({u, gv, dwg, dbg, W, W, W, 0, W, W, 1.f});
  for (int d = 0; d < depth; ++d)
    probs.push_back({x, dz + d * H, dwall + d * H, dball + d * H, W, ldb, ldb, 0, W, H, 1.f});

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int p0 = 0; p0 < (int)probs.size(); p0 += WG_MAX_PROBLEMS) {
    const int left = (int)probs.size() - p0;
    const int n = left < WG_MAX_PROBLEMS ? left : WG_MAX_PROBLEMS;
    WgradBatch batch{};
    for (int i = 0; i < n; ++i) batch.p[i] = probs[p0 + i];
    wgrad_partial_kernel<<<dim3(n_split, n), NT, 0, s>>>(batch, p0, partials, B, T, n_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wgrad_reduce_kernel<<<dim3((WG_PART + NT - 1) / NT, n), NT, 0, s>>>(batch, p0, partials, n_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
