// Weight gradients as sums over the frames of a batch: B5's head-grouped
// relative tables and LayerNorm gains (enc_layer_bwd.cu) and B6's diagonal
// sums (flow_step_bwd.cu); the products of one group a frame take
// wgrad_mma.cuh, on the same Problem. fp32 on the CUDA cores; no atomics,
// so two calls are bitwise equal.
//
// A problem is one gradient over the rows r of a [B, T] batch (rows grouped
// `groups` to a frame when a frame holds several heads):
//   outer: out_w[n * ldn + m * ldm] = sum_r Y[r, n] * X[r + shift, m]
//   diag:  out_w[n * ldn]           = sum_r Y[r, n] * X[r, n]
//   out_b[n] = sum_r Y[r, n] when out_b is set (a bias gradient); with out_w
//   null a problem gives only these column sums
// where row r is frame f = r / groups, group g = r % groups of sequence
// b = f / T at t = f % T; Y[r, n] = Y[f * ldy + g * gy + n], zero at t >=
// lens[b] when mask_y; X[r + shift, m] = X[(f + shift) * ldx + g * gx + m],
// zero when t + shift leaves [0, T) (a conv tap's offset) or, when mask_x,
// reaches lens[b].
//
// Design (the split-over-time reduction of gated_hifi_bwd.cu, generalised):
// each problem is cut into 64 x 64 tiles of (n, m) and its rows into n_split
// slices; one block of the partial kernel sums one slice of one tile in a
// fixed order (16-row slabs through shared memory, 4 x 4 outputs a thread)
// into its own partial, and the reduce kernel adds the slices' partials in
// slice order.
//
// fp32 only: the bf16 backwards sum their weights on bf16_engine.cuh.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <vector>

namespace wgrad_rows {

constexpr int NT = 256;
constexpr int TILE = 64;
constexpr int SLAB = 16;
constexpr int PART = TILE * TILE + TILE;  // a partial: the tile, then its column sums of Y
constexpr int MAX_PROBLEMS = 40;          // per launch: the batch travels as a kernel parameter (< 4 KB)

struct Problem {
  const float* X;
  const float* Y;
  float* out_w;
  float* out_b;
  long long part;  // this problem's first partial float
  int ldx, ldy, gx, gy, groups, M, N, shift, mask_x, mask_y, diag, ldn, ldm;
};
static_assert(sizeof(Problem) == 96, "the kernels' parameters keep their layout");

struct Batch {
  Problem p[MAX_PROBLEMS];
};
static_assert(sizeof(Batch) + 64 <= 4096, "a launch's problems must fit the 4 KB of kernel parameters");

__host__ __device__ inline int m_tiles(const Problem& p) { return p.diag ? 1 : (p.M + TILE - 1) / TILE; }
__host__ __device__ inline int tiles(const Problem& p) { return (p.N + TILE - 1) / TILE * m_tiles(p); }

// Lays the problems' partials out one after another; returns the floats they need.
inline long long assign_partials(std::vector<Problem>& probs, int n_split) {
  long long total = 0;
  for (Problem& p : probs) {
    p.part = total;
    total += (long long)tiles(p) * n_split * PART;
  }
  return total;
}

template <class Tag>
__global__ void __launch_bounds__(NT) wgrad_partial_kernel(const Batch batch, const int* __restrict__ lens,
                                                           int B, int T, int n_split,
                                                           float* __restrict__ partials) {
  __shared__ float ys[SLAB][TILE];
  __shared__ float xs[SLAB][TILE];
  const Problem& pr = batch.p[blockIdx.y];
  const int tile = blockIdx.x;
  if (tile >= tiles(pr)) return;
  const int mt = m_tiles(pr);
  const int n0 = tile / mt * TILE, m0 = tile % mt * TILE;
  const int s = blockIdx.z;
  const long long rows = (long long)B * T * pr.groups;
  const long long chunk = (rows + n_split - 1) / n_split;
  const long long r_begin = s * chunk;
  const long long r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // n = ty + 16 i, m = tx + 16 j

  float acc[4][4] = {};
  float colsum = 0.f, diag = 0.f;  // column tid's sums, tid < TILE
  for (long long r0 = r_begin; r0 < r_end; r0 += SLAB) {
    for (int e = tid; e < SLAB * TILE; e += NT) {
      const int rr = e / TILE, c = e % TILE;
      const long long r = r0 + rr;
      float yv = 0.f, xv = 0.f;
      if (r < r_end) {
        const long long f = r / pr.groups;
        const int g = (int)(r % pr.groups);
        const int b = (int)(f / T), t = (int)(f % T), len = lens[b];
        const int n = n0 + c, m = (pr.diag ? n0 : m0) + c, ts = t + pr.shift;
        if (n < pr.N && !(pr.mask_y && t >= len)) {
          const long long i = f * pr.ldy + (long long)g * pr.gy + n;
          yv = pr.Y[i];
        }
        if (m < (pr.diag ? pr.N : pr.M) && ts >= 0 && ts < T && !(pr.mask_x && ts >= len)) {
          const long long i = (f + pr.shift) * pr.ldx + (long long)g * pr.gx + m;
          xv = pr.X[i];
        }
      }
      ys[rr][c] = yv;
      xs[rr][c] = xv;
    }
    __syncthreads();
    if (pr.diag) {
      if (tid < TILE)
        for (int rr = 0; rr < SLAB; ++rr) diag = fmaf(ys[rr][tid], xs[rr][tid], diag);
    } else {
#pragma unroll 4
      for (int rr = 0; rr < SLAB; ++rr) {
        float yn[4], xm[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yn[i] = ys[rr][ty + 16 * i];
          xm[i] = xs[rr][tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(yn[i], xm[j], acc[i][j]);
      }
    }
    if (tid < TILE)
      for (int rr = 0; rr < SLAB; ++rr) colsum += ys[rr][tid];
    __syncthreads();
  }

  float* out = partials + pr.part + ((long long)tile * n_split + s) * PART;
  if (pr.diag) {
    if (tid < TILE) out[tid] = diag;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[(ty + 16 * i) * TILE + tx + 16 * j] = acc[i][j];
  }
  if (tid < TILE) out[TILE * TILE + tid] = colsum;
}

template <class Tag>
__global__ void __launch_bounds__(NT) wgrad_reduce_kernel(const Batch batch, int n_split,
                                                          const float* __restrict__ partials) {
  const Problem& pr = batch.p[blockIdx.z];
  const int tile = blockIdx.y;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (tile >= tiles(pr) || e >= PART || (e < TILE * TILE && !pr.out_w)) return;
  const int mt = m_tiles(pr);
  const int n0 = tile / mt * TILE, m0 = tile % mt * TILE;
  int n, m = 0;
  if (e >= TILE * TILE) {
    n = n0 + e - TILE * TILE;  // a column sum of Y
    if (!pr.out_b || m0 != 0 || n >= pr.N) return;
  } else if (pr.diag) {
    n = n0 + e;
    if (e >= TILE || n >= pr.N) return;
  } else {
    n = n0 + e / TILE;
    m = m0 + e % TILE;
    if (n >= pr.N || m >= pr.M) return;
  }
  const float* src = partials + pr.part + (long long)tile * n_split * PART + e;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += src[(long long)s * PART];  // fixed order
  if (e >= TILE * TILE)
    pr.out_b[n] = sum;
  else
    pr.out_w[(long long)n * pr.ldn + (long long)m * pr.ldm] = sum;
}

// Both kernels for every problem, MAX_PROBLEMS at a time, on `stream`.
template <class Tag>
cudaError_t run(const std::vector<Problem>& probs, const int* lens, int B, int T, int n_split, float* partials,
                cudaStream_t stream) {
  for (size_t p0 = 0; p0 < probs.size(); p0 += MAX_PROBLEMS) {
    const int n = (int)(probs.size() - p0 < (size_t)MAX_PROBLEMS ? probs.size() - p0 : MAX_PROBLEMS);
    Batch batch{};
    int max_tiles = 1;
    for (int i = 0; i < n; ++i) {
      batch.p[i] = probs[p0 + i];
      max_tiles = tiles(batch.p[i]) > max_tiles ? tiles(batch.p[i]) : max_tiles;
    }
    wgrad_partial_kernel<Tag><<<dim3(max_tiles, n, n_split), NT, 0, stream>>>(batch, lens, B, T, n_split,
                                                                                   partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wgrad_reduce_kernel<Tag><<<dim3((PART + NT - 1) / NT, max_tiles, n), NT, 0, stream>>>(batch, n_split,
                                                                                              partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// A problem with the common defaults (one group, no shift, no masks, outer, no bias).
inline Problem problem(const float* X, int ldx, int M, const float* Y, int ldy, int N, float* out_w, int ldn,
                       int ldm) {
  Problem p{};
  p.X = X; p.ldx = ldx; p.M = M;
  p.Y = Y; p.ldy = ldy; p.N = N;
  p.out_w = out_w; p.ldn = ldn; p.ldm = ldm;
  p.groups = 1;
  return p;
}

}  // namespace wgrad_rows
