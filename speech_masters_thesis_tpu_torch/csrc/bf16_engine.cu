// The kernels and launches of the bf16 backward engine (bf16_engine.cuh)
// that B3's, B6's and B5's bf16 backwards share: the weight sums with the
// frames as wgmma's K and their fixed-order reduction, the packing launch
// and the bias sums. Built once here; the backwards' sources call the host
// functions.
//
// The weight sums (wn16_wsum_kernel): a block computes 64 x 128 outputs of
// one problem over the frames (the frames as wgmma's K, both operands
// MN-major as they lie in device memory, fp32 sums every FLUSH slabs) and
// writes them in the gradient's own layout and dtype; where the jobs are
// too few to fill the card, over a fixed share of the frames, and
// wn16_wsum_reduce_kernel adds the shares in a fixed order. No float
// atomics: two calls are bitwise equal.

#include "bf16_engine.cuh"

namespace wn16 {

struct WParams {
  CUtensorMap maps[W_MAPS];
  WProb prob[MAX_PROBS];
  float* part;
  int n_probs, n_split, ntt, slabs;
};

__device__ __forceinline__ int prob_of(const WParams& p, int block) {
  int i = 0;
  while (i + 1 < p.n_probs && block >= p.prob[i + 1].block0) ++i;
  return i;
}

// one 64 x 128 job of a problem over its share of the slabs (64 frames of a
// sequence), split = block % n_split; its fp32 sums to the partials in the
// accumulators' order
__global__ void __launch_bounds__(THREADS) wn16_wsum_kernel(const __grid_constant__ WParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + W_BAR_OFF);
  const WProb& P = p.prob[prob_of(p, blockIdx.x)];
  const int local = blockIdx.x - P.block0, split = local % p.n_split, job = local / p.n_split;
  const int mi = job % P.mchunks, ni = job / P.mchunks;
  const int chunk = cdiv(p.slabs, p.n_split), s0 = split * chunk;
  const int n = max(0, min(p.slabs, s0 + chunk) - s0);
  const bool lead = threadIdx.x == 0;
  if (lead) {
    for (int i = 0; i < RING; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto load = [&](int k) {
    if (k >= n) return;
    const int s = s0 + k, b = s / p.ntt, t0 = (s % p.ntt) * TM;
    uint64_t* const f = &full[k % RING];
    uint8_t* const st = sm + (k % RING) * W_SLOT;
    mbar_expect_tx(f, W_SLOT);
    tma_load_3d(st, &p.maps[P.xmap], f, KC * mi, t0 + P.shift, P.xplane + b);
    tma_load_3d(st + W_CHUNK, &p.maps[P.ymap], f, 128 * ni, t0, P.yplane + b);
    tma_load_3d(st + 2 * W_CHUNK, &p.maps[P.ymap], f, 128 * ni + KC, t0, P.yplane + b);
  };
  if (lead)
    for (int k = 0; k < RING; ++k) load(k);
  float acc[64], sum[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = sum[r] = 0.f;
  for (int k = 0; k < n; ++k) {
    mbar_wait(&full[k % RING], (uint32_t)(k / RING) & 1u);
    const uint32_t xa = smem_u32(sm + (k % RING) * W_SLOT), yb = xa + W_CHUNK;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk)
      mma_k16<128, 1, 1>(acc, desc_b128(xa + 2048 * kk, W_CHUNK, 1024), desc_b128(yb + 2048 * kk, W_CHUNK, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lead) load(k + RING);
    if ((k + 1) % FLUSH == 0 || k + 1 == n) {
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        sum[r] += acc[r];
        acc[r] = 0.f;
      }
    }
  }
  if (p.n_split == 1) {  // the whole sum: straight into the gradient, in its layout and dtype
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < 64; ++r) {  // register r: row 16 warp + lane / 4 + 8 ((r / 2) % 2), column 8 (r / 4) + ...
      const int M = KC * mi + 16 * warp + (lane >> 2) + 8 * ((r >> 1) & 1);
      const int N = 128 * ni + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      if (M >= P.M || N >= P.N) continue;
      const size_t o = (size_t)M * P.sm + (size_t)N * P.sn;
      if (P.f32)
        static_cast<float*>(P.out)[o] = sum[r];
      else
        static_cast<bf16_t*>(P.out)[o] = __float2bfloat16_rn(sum[r]);
    }
    return;
  }
  float2* const part = reinterpret_cast<float2*>(p.part) + (size_t)blockIdx.x * (JOB_FLOATS / 2) + threadIdx.x;
#pragma unroll
  for (int pr = 0; pr < 32; ++pr) part[pr * 128] = make_float2(sum[2 * pr], sum[2 * pr + 1]);
}

constexpr int REDUCE_THREADS = 1024;  // a job's 8,192 sums: 8 a thread, many loads in flight

// each job's shares added in a fixed order (read as they lie, into shared
// memory), then written once in the gradient's layout and dtype, the
// output's smaller stride varying fastest across the threads
__global__ void __launch_bounds__(REDUCE_THREADS) wn16_wsum_reduce_kernel(const __grid_constant__ WParams p) {
  __shared__ float acc[JOB_FLOATS];
  const int jg = blockIdx.x;
  int i = 0;
  while (i + 1 < p.n_probs && jg >= p.prob[i + 1].block0 / p.n_split) ++i;
  const WProb& P = p.prob[i];
  const int job = jg - P.block0 / p.n_split, mi = job % P.mchunks, ni = job / P.mchunks;
  const float* src = p.part + (size_t)(P.block0 + job * p.n_split) * JOB_FLOATS;
#pragma unroll 8
  for (int e = threadIdx.x; e < JOB_FLOATS; e += REDUCE_THREADS) {
    float s = 0.f;
    for (int k = 0; k < p.n_split; ++k) s += src[(size_t)k * JOB_FLOATS + e];
    acc[e] = s;
  }
  __syncthreads();
  const bool m_fast = P.sm <= P.sn;
  for (int e = threadIdx.x; e < JOB_FLOATS; e += REDUCE_THREADS) {
    const int m = m_fast ? e & 63 : e >> 7, n = m_fast ? e >> 6 : e & 127;
    const int M = KC * mi + m, N = 128 * ni + n;
    if (M >= P.M || N >= P.N) continue;
    // where the accumulators keep (m, n): thread (m / 16) * 32 + (m % 8) * 4 + (n % 8) / 2, register
    // 4 (n / 8) + 2 ((m % 16) / 8) + n % 2
    const int th = (m >> 4) * 32 + (m & 7) * 4 + ((n & 7) >> 1);
    const int pr = 2 * (n >> 3) + ((m >> 3) & 1);
    const float v = acc[(pr * 128 + th) * 2 + (n & 1)];
    const size_t o = (size_t)M * P.sm + (size_t)N * P.sn;
    if (P.f32)
      static_cast<float*>(P.out)[o] = v;
    else
      static_cast<bf16_t*>(P.out)[o] = __float2bfloat16_rn(v);
  }
}

// ---- packing ------------------------------------------------------------------------
__global__ void __launch_bounds__(256) wn16_pack_kernel(const __grid_constant__ PackParams p) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (int i = 0; i < p.n; ++i) {
    const PackJob& J = p.job[i];
    const unsigned total = (unsigned)J.planes * J.rows * J.cols;  // < 2^31 (pack)
    for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
      const int c = (int)(e % (unsigned)J.cols);
      const unsigned rj = e / (unsigned)J.cols;
      const int r = (int)(rj % (unsigned)J.rows), j = (int)(rj / (unsigned)J.rows);
      int sr = r;
      bool ok = c < J.src_cols;
      if (J.kind == P_GATE) {  // row group g: tanh channels 32 g .. 32 g + 31, then their sigmoid channels
        const int g = r / 64, w = r % 64, ch = 32 * g + (w & 31);
        sr = w < 32 ? ch : J.H + ch;
        ok = ok && ch < J.H;
      } else {
        ok = ok && r < J.src_rows;
      }
      float v = 0.f;
      if (ok) {
        const long long at = j * J.s_plane + sr * J.s_row + c * J.s_col;
        v = J.kind == P_F32 ? static_cast<const float*>(J.src)[at] : f32(static_cast<const bf16_t*>(J.src)[at]);
        if (J.kind == P_ACTNORM || J.kind == P_MASKED) {  // rows are the frames of [B, T]
          const bool valid = r % p.T < p.lens[r / p.T];
          v = J.kind == P_ACTNORM ? (p.alb[c] + expf(p.aln[c]) * v) * (valid ? 1.f : 0.f) : v * (valid ? 1.f : 0.f);
        }
      }
      J.dst[((long long)j * J.rows + r) * J.pitch + c] = __float2bfloat16_rn(v);
    }
  }
}

// ---- column sums ----------------------------------------------------------------------
constexpr int SUM_SOURCES = 16, SUM_OUTS = 48;  // a launch's (its parameters stay under 4 KB)

struct SumSrc {
  const float* part;
  const bf16_t* in;
  float* out32;
  int rows, width, ld, out0, n_out;
};

struct SumParams {
  SumSrc src[SUM_SOURCES];
  bf16_t* out[SUM_OUTS];
};

__global__ void __launch_bounds__(1024) wn16_bias_kernel(const __grid_constant__ SumParams p) {
  __shared__ float s[32][33];
  const SumSrc& q = p.src[blockIdx.y];
  const int cx = threadIdx.x & 31, r = threadIdx.x >> 5, c = blockIdx.x * 32 + cx;
  float v = 0.f;
  if (c < q.width) {
    if (q.part)
      for (int i = r; i < q.rows; i += 32) v += q.part[(size_t)i * q.ld + c];
    else
      for (int i = r; i < q.rows; i += 32) v += f32(q.in[(size_t)i * q.ld + c]);
  }
  s[r][cx] = v;
  __syncthreads();
  if (r != 0 || c >= q.width) return;
  float t = 0.f;
  for (int k = 0; k < 32; ++k) t += s[k][cx];
  if (q.out32) q.out32[c] = t;
  const bf16_t tb = __float2bfloat16_rn(t);
  for (int j = 0; j < q.n_out; ++j) p.out[q.out0 + j][c] = tb;
}

// ---- host ------------------------------------------------------------------------------
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// the problems' launches (at most MAX_PROBS each) with their blocks assigned; the frame split
int assign(std::vector<WProb>& v, int B, int T, long long* most_blocks) {
  long long jobs = 0;
  for (const WProb& q : v) jobs += (long long)q.mchunks * q.ntiles;
  const int slabs = B * cdiv(T, TM);
  // about two resident blocks an SM; one share a job (no partials) where the jobs fill that
  const long long target = 2LL * (sm_count() > 0 ? sm_count() : 132);
  int n_split = (int)((target + jobs / 2) / jobs);
  n_split = n_split < 1 ? 1 : n_split > slabs ? slabs : n_split;
  *most_blocks = 0;
  for (size_t u0 = 0; u0 < v.size(); u0 += MAX_PROBS) {
    int block = 0;
    for (size_t i = u0; i < v.size() && i < u0 + MAX_PROBS; ++i) {
      v[i].block0 = block;
      block += v[i].mchunks * v[i].ntiles * n_split;
    }
    *most_blocks = block > *most_blocks ? block : *most_blocks;
  }
  return n_split;
}

cudaError_t weight_sums(std::vector<WProb> v, int B, int T, const CUtensorMap (&maps)[W_MAPS], float* part,
                        cudaStream_t s) {
  long long most;
  const int n_split = assign(v, B, T, &most);
  WParams p{};
  for (int i = 0; i < W_MAPS; ++i) p.maps[i] = maps[i];
  p.part = part;
  p.n_split = n_split;
  p.ntt = cdiv(T, TM);
  p.slabs = B * p.ntt;
  cudaError_t err = allow_smem<wn16_wsum_kernel>(W_SMEM);
  for (size_t u0 = 0; u0 < v.size() && err == cudaSuccess; u0 += MAX_PROBS) {
    p.n_probs = (int)(v.size() - u0 < (size_t)MAX_PROBS ? v.size() - u0 : MAX_PROBS);
    for (int i = 0; i < p.n_probs; ++i) p.prob[i] = v[u0 + i];
    const WProb& last = p.prob[p.n_probs - 1];
    const int blocks = last.block0 + last.mchunks * last.ntiles * n_split;
    wn16_wsum_kernel<<<blocks, THREADS, W_SMEM, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) continue;
    wn16_wsum_reduce_kernel<<<blocks / n_split, REDUCE_THREADS, 0, s>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

cudaError_t pack(std::vector<PackJob>& jobs, const int* lens, int T, const float* aln, const float* alb,
                 cudaStream_t s) {
  PackParams p{};
  p.T = T;
  p.lens = lens;
  p.aln = aln;
  p.alb = alb;
  const int grid = 4 * (sm_count() > 0 ? sm_count() : 132);
  for (const PackJob& J : jobs)
    if ((long long)J.planes * J.rows * J.cols >= (1LL << 31)) return cudaErrorInvalidValue;
  for (size_t u0 = 0; u0 < jobs.size(); u0 += MAX_JOBS) {
    p.n = (int)(jobs.size() - u0 < (size_t)MAX_JOBS ? jobs.size() - u0 : MAX_JOBS);
    for (int i = 0; i < p.n; ++i) p.job[i] = jobs[u0 + i];
    wn16_pack_kernel<<<grid, 256, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// the sources in launches of at most SUM_SOURCES sources and SUM_OUTS
// outputs; a source with more outputs is summed once for each SUM_OUTS of
// them (in the same order, so to the same bits)
cudaError_t column_sums(const std::vector<SumSource>& sources, cudaStream_t s) {
  SumParams p{};
  int n = 0, outs = 0, widest = 0;
  auto launch = [&]() -> cudaError_t {
    if (n == 0) return cudaSuccess;
    wn16_bias_kernel<<<dim3(cdiv(widest, 32), n), 1024, 0, s>>>(p);
    n = outs = widest = 0;
    return cudaGetLastError();
  };
  for (const SumSource& q : sources) {
    size_t j = 0;
    do {
      const int k = (int)(q.outs.size() - j < (size_t)SUM_OUTS ? q.outs.size() - j : SUM_OUTS);
      if (n == SUM_SOURCES || outs + k > SUM_OUTS) {
        const cudaError_t err = launch();
        if (err != cudaSuccess) return err;
      }
      p.src[n] = SumSrc{q.part, q.in, j == 0 ? q.out32 : nullptr, q.rows, q.width, q.ld, outs, k};
      for (int i = 0; i < k; ++i) p.out[outs + i] = q.outs[j + i];
      outs += k;
      widest = q.width > widest ? q.width : widest;
      ++n;
      j += k;
    } while (j < q.outs.size());
  }
  return launch();
}

}  // namespace wn16
