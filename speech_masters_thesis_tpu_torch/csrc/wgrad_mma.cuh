// wgrad_rows.cuh's outer-product problems on the tensor cores in 3xTF32
// (tf32_mma.cuh), for the Glow-TTS recompute backwards (wn_coupling_bwd.cu,
// flow_step_bwd.cu, enc_layer_bwd.cu): one group a frame and no diagonal
// forms (B6's daln and dalb, B5's head-grouped relative tables and
// LayerNorm gains stay on wgrad_rows.cuh's CUDA-core kernels). For each problem, over
// the rows r of a [B, T] batch,
//   out_w[n * ldn + m * ldm] = sum_r Y[r, n] * X[r + shift, m]
//   out_b[n] = sum_r Y[r, n] when out_b is set
// with wgrad_rows.cuh's masks (mask_x, mask_y) and zeros where t + shift
// leaves [0, T).
//
// Design (B1's reduction in gated_hifi_bwd.cu, generalised): the frames
// are the MMAs' k. Each problem is cut into TMW x TNW = 64 x 128 tiles of
// (m, n) and the frames into n_split slices; one block sums one slice of
// one tile over 32-frame slabs of X and Y, staged by cp.async and double
// buffered (16-byte pieces when every problem's widths, strides and
// pointers are multiples of 4 floats, WHOLE, else tf32::stage4's 4-byte
// ones), 8 warps of 32 x 32 in m16n8k8 MMAs. Its
// accumulators go into its own partial (in fragment order) every FLUSH slabs,
// added in fp32: the tensor cores' accumulation truncates, so at most 1,024
// frames' MMAs meet one register. The reduce kernel adds the slices'
// partials in slice order: no atomics, two calls are bitwise equal. The
// slice count fills whole waves of the card's resident blocks (splits).
//
// fp32 only: the bf16 backwards sum their weights on bf16_engine.cuh.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <vector>

#include "tf32_mma.cuh"
#include "wgrad_rows.cuh"

namespace wgrad_mma {

using wgrad_rows::Problem;

constexpr int NT = 256;
constexpr int TMW = 64, TNW = 128;          // a tile: X channels m by Y channels n
constexpr int KF = 32;                      // frames a slab: four k-steps
constexpr int STAGES = 2;                   // slabs in flight
constexpr int FLUSH = 32;                   // slabs between two adds into the partial
constexpr int LDX = TMW + 8, LDY = TNW + 8;  // slab row strides: conflict-free fragment reads
constexpr int STAGE_FLOATS = KF * (LDX + LDY);
constexpr size_t SMEM = sizeof(float) * STAGES * STAGE_FLOATS;
constexpr int PART = TMW * TNW + TNW;       // a partial: the tile (fragment order), then Y's column sums
constexpr int MAX_PROBLEMS = wgrad_rows::MAX_PROBLEMS;

struct Batch {
  Problem p[MAX_PROBLEMS];
  int n;
};
static_assert(sizeof(Batch) + 64 <= 4096, "a launch's problems must fit the 4 KB of kernel parameters");

__host__ __device__ inline int m_tiles_of(const Problem& p) { return (p.M + TMW - 1) / TMW; }
__host__ __device__ inline int tiles_of(const Problem& p) { return m_tiles_of(p) * ((p.N + TNW - 1) / TNW); }

// p.part = the problem's first tile (counting every problem's before it); returns the tiles
inline long long assign_tiles(std::vector<Problem>& probs) {
  long long total = 0;
  for (Problem& p : probs) {
    p.part = total;
    total += tiles_of(p);
  }
  return total;
}

template <class Tag, bool WHOLE>
__global__ void __launch_bounds__(NT, 2) wgrad_mma_kernel(const Batch batch, const int* __restrict__ lens, int B,
                                                          int T, int n_split, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  // the block's problem and tile: blockIdx.x counts the batch's tiles
  const long long tile = batch.p[0].part + blockIdx.x;
  int q = 0;
  while (q + 1 < batch.n && batch.p[q + 1].part <= tile) ++q;
  const Problem& pr = batch.p[q];
  const int lt = (int)(tile - pr.part), mt_n = m_tiles_of(pr);
  const int m0 = lt % mt_n * TMW, n0 = lt / mt_n * TNW;
  const long long rows = (long long)B * T;
  const long long chunk = (rows + n_split - 1) / n_split;
  const long long r_begin = (long long)blockIdx.y * chunk;
  const long long r_end = r_begin + chunk < rows ? r_begin + chunk : rows;
  const int n_slabs = r_end > r_begin ? (int)((r_end - r_begin + KF - 1) / KF) : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = (warp % 2) * 32, wcol = (warp / 2) * 32;  // the warp's 32 x 32
  const bool active = m0 + wrow < pr.M && n0 + wcol < pr.N;
  const int gr = lane >> 2, qd = lane & 3;
  const bool sums = pr.out_b != nullptr && m0 == 0;
  const int col = threadIdx.x % TNW;  // this thread's column of the column sums

  auto load = [&](int slab) {
    float* xs = smem + (slab % STAGES) * STAGE_FLOATS;
    float* ys = xs + KF * LDX;
    const long long r0 = r_begin + (long long)slab * KF;
    for (int f = threadIdx.x; f < KF * (TMW / 4); f += NT) {
      const int rr = f / (TMW / 4), m = m0 + 4 * (f % (TMW / 4));
      const long long r = r0 + rr;
      bool in = r < r_end && m < pr.M;
      if (in) {
        const int b = (int)(r / T), ts = (int)(r % T) + pr.shift;
        in = ts >= 0 && ts < T && !(pr.mask_x && ts >= lens[b]);
      }
      float* dst = xs + rr * LDX + 4 * (f % (TMW / 4));
      if (WHOLE)
        tf32::cp_async16(dst, in ? pr.X + (r + pr.shift) * pr.ldx + m : pr.X, in ? 16 : 0);
      else
        tf32::stage4(dst, [&](int e) -> const float* {
          return in && m + e < pr.M ? pr.X + (r + pr.shift) * pr.ldx + m + e : nullptr;
        });
    }
    for (int f = threadIdx.x; f < KF * (TNW / 4); f += NT) {
      const int rr = f / (TNW / 4), n = n0 + 4 * (f % (TNW / 4));
      const long long r = r0 + rr;
      bool in = r < r_end && n < pr.N;
      if (in && pr.mask_y) in = (int)(r % T) < lens[r / T];
      float* dst = ys + rr * LDY + 4 * (f % (TNW / 4));
      if (WHOLE)
        tf32::cp_async16(dst, in ? pr.Y + r * pr.ldy + n : pr.Y, in ? 16 : 0);
      else
        tf32::stage4(dst, [&](int e) -> const float* {
          return in && n + e < pr.N ? pr.Y + r * pr.ldy + n + e : nullptr;
        });
    }
  };

  // this thread's accumulator pairs in the partial: (mt, nt, h) at
  // ((mt * 4 + nt) * 2 + h) * 64 floats from here, a warp's 32 lanes side by side
  float* part = partials + ((size_t)(tile * n_split + blockIdx.y)) * PART;
  float* frag = part + warp * 1024 + 2 * lane;
  float acc[2][4][4] = {};
  auto flush = [&](bool first) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* d = reinterpret_cast<float2*>(frag + ((mt * 4 + nt) * 2 + h) * 64);
          float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          if (!first) {
            const float2 o = *d;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *d = v;
          acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
        }
  };
  float colsum = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs) load(s);
    tf32::cp_async_commit();
  }
  for (int s = 0; s < n_slabs; ++s) {
    tf32::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab s has landed, and every warp is done with slab s - 1
    if (s + STAGES - 1 < n_slabs) load(s + STAGES - 1);
    tf32::cp_async_commit();
    const float* xs = smem + (s % STAGES) * STAGE_FLOATS;
    const float* ys = xs + KF * LDX;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < KF / 8; ++kk) {
        // A (m, k) = X[frame k, channel m]: the slab's rows are frames
        tf32::FragA fa[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* x = xs + (8 * kk + qd) * LDX + wrow + 16 * mt + gr;
          fa[mt] = tf32::frag_a(x[0], x[8], x[4 * LDX], x[4 * LDX + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* y = ys + (8 * kk + qd) * LDY + wcol + 8 * nt + gr;
          const tf32::FragB fb = tf32::frag_b(y[0], y[4 * LDY]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) tf32::mma3(acc[mt][nt], fa[mt], fb);
        }
      }
      if ((s + 1) % FLUSH == 0 || s + 1 == n_slabs) flush(s < FLUSH);
    }
    if (sums)
      for (int rr = threadIdx.x / TNW; rr < KF; rr += NT / TNW) colsum += ys[rr * LDY + col];
  }
  tf32::cp_async_wait<0>();
  __syncthreads();  // the staging buffers are free: the column sums' halves meet there

  if (active && n_slabs == 0) flush(true);  // an empty slice: zeros
  if (sums) {
    smem[threadIdx.x] = colsum;
    __syncthreads();
    if (threadIdx.x < TNW) {
      float sum = 0.f;
      for (int h = threadIdx.x; h < NT; h += TNW) sum += smem[h];  // fixed order
      part[TMW * TNW + threadIdx.x] = sum;
    }
  }
}

template <class Tag>
__global__ void __launch_bounds__(NT) wgrad_mma_reduce_kernel(const Batch batch, int n_split,
                                                              const float* __restrict__ partials) {
  const long long tile = batch.p[0].part + blockIdx.y;
  int q = 0;
  while (q + 1 < batch.n && batch.p[q + 1].part <= tile) ++q;
  const Problem& pr = batch.p[q];
  const int lt = (int)(tile - pr.part), mt_n = m_tiles_of(pr);
  const int m0 = lt % mt_n * TMW, n0 = lt / mt_n * TNW;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= PART) return;
  int m, n, at = e;  // where the partial keeps (m, n): wgrad_mma_kernel's accumulator layout
  if (e >= TMW * TNW) {  // a column sum
    m = -1;
    n = e - TMW * TNW;
    if (!pr.out_b || m0 != 0) return;
  } else {
    m = e / TNW;
    n = e % TNW;
    if (!pr.out_w) return;
    const int warp = m / 32 + 2 * (n / 32), r = m % 32, c = n % 32;
    const int lane = (r % 8) * 4 + (c % 8) / 2;
    at = warp * 1024 + (((r / 16) * 4 + c / 8) * 2 + (r % 16) / 8) * 64 + lane * 2 + c % 2;
  }
  if (n0 + n >= pr.N || m0 + m >= pr.M) return;
  const float* src = partials + (size_t)tile * n_split * PART + at;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += src[(size_t)s * PART];  // fixed order
  if (m < 0)
    pr.out_b[n0 + n] = sum;
  else
    pr.out_w[(long long)(n0 + n) * pr.ldn + (long long)(m0 + m) * pr.ldm] = sum;
}

// Slices of the B * T frames for `tile_count` tiles: at least one slab a
// slice, about 1,024 frames, at most 64, then as many as fill the waves
// that takes of the card's resident blocks (queried once). The partials
// need tile_count * splits * PART floats.
template <class Tag>
int splits(long long tile_count, long long rows) {
  static int slots = 0;
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return -1;
    auto kernel = wgrad_mma_kernel<Tag, true>;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, SMEM) != cudaSuccess || per_sm < 1)
      return -1;
    slots = sms * per_sm;
  }
  if (tile_count < 1 || rows < 1) return 1;
  const long long n = (rows + 1023) / 1024 < 64 ? (rows + 1023) / 1024 : 64;
  const long long waves = (tile_count * n + slots - 1) / slots;
  const long long fill = waves * slots / tile_count;
  const long long most = (rows + KF - 1) / KF;
  return (int)(fill < 1 ? 1 : fill < most ? fill : most);
}

// Every problem's X and Y in 16-byte pieces: widths, row strides and pointers in multiples of 4 floats
inline bool whole_pieces(const std::vector<Problem>& probs) {
  for (const Problem& p : probs) {
    const bool x = tf32::aligned16(p.X) && p.ldx % 4 == 0 && p.M % 4 == 0;
    const bool y = tf32::aligned16(p.Y) && p.ldy % 4 == 0 && p.N % 4 == 0;
    if (!x || !y) return false;
  }
  return true;
}

// Both kernels for every problem (assign_tiles first), MAX_PROBLEMS at a
// time, on `stream`: the slices in 16-byte pieces when whole_pieces, else
// in 4-byte ones.
template <class Tag>
cudaError_t run(const std::vector<Problem>& probs, const int* lens, int B, int T, int n_split, float* partials,
                cudaStream_t stream) {
  auto kernel = whole_pieces(probs) ? wgrad_mma_kernel<Tag, true> : wgrad_mma_kernel<Tag, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  for (size_t p0 = 0; p0 < probs.size(); p0 += MAX_PROBLEMS) {
    Batch batch{};
    batch.n = (int)(probs.size() - p0 < (size_t)MAX_PROBLEMS ? probs.size() - p0 : MAX_PROBLEMS);
    int n_tiles = 0;
    for (int i = 0; i < batch.n; ++i) {
      batch.p[i] = probs[p0 + i];
      n_tiles += tiles_of(batch.p[i]);
    }
    kernel<<<dim3(n_tiles, n_split), NT, SMEM, stream>>>(batch, lens, B, T, n_split, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wgrad_mma_reduce_kernel<Tag><<<dim3((PART + NT - 1) / NT, n_tiles), NT, 0, stream>>>(batch, n_split,
                                                                                              partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace wgrad_mma
