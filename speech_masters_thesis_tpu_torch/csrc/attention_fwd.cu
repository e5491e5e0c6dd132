// Small-T causal attention forward for Hopper (sm_90a), fp32, with in-kernel
// dropout.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/attention.py, function
// fused_attention -> pallas_call(_fwd_kernel). The backward is
// attention_bwd.cu.
//
// What it computes, per sequence b, head h and query row r (masking and
// dropout as in attention_common.cuh):
//   s_c = (q_r . k_c) * scale        over the valid keys c
//   p_c = exp(s_c - m) / l           m = max_c s_c, l = sum_c exp(s_c - m)
//   o_r = sum_c p_c * keep(r, c) * v_c
// and it stores (m, l) per row for the backward.
//
// What bounds it on an H100. The TPU program keeps one head's whole [T, T]
// score matrix in VMEM and loops over the 16 heads of one sequence per grid
// step. On the card that matrix does not fit a block (266 KB at T=258,
// 4 MB at T=1024, against 227 KB of shared memory), and 8 sequences would
// give 8 blocks for 132 SMs. The work is small: at the LM's shapes
// (T=258, D=32) a (query, key) pair costs 64 FMAs and one 32-bit hash when
// dropping, against 256 bytes of q, k, v and o per row, so arithmetic and
// the latency of shared-memory reads bound it, not device memory.
//
// Design: one block of 64 threads per (64-row query tile, head, sequence),
// 640 blocks at B=8, T=258, H=16. Each thread owns one query row: its q
// row and its o accumulator (32 floats each) live in registers. K and V
// stream through shared memory in 64-key tiles over the block's causal
// prefix [0, min(last row + 1, len_b)), so any T works in 16 KB of shared
// memory. The softmax is online (running max m and sum l per row), updated
// once per chunk of 16 keys. The loads of a key row are broadcasts (every
// lane of a warp reads the same row), as 16-byte loads. Plain fp32 FMA on the
// CUDA cores; tensor cores (TF32 would not meet the fp32 tolerance),
// wgmma and TMA are later work.
//
// Residuals: the TPU kernel saves nothing and its backward recomputes the
// softmax statistics. Here the forward also writes (m, l) per row,
// [B, H, T] float2, and the autograd function keeps O (which the output
// projection keeps anyway), so the backward recomputes P = exp(s - m) / l
// without a pass for the statistics.

#include "attention_common.cuh"

namespace attention {
namespace {

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, int ld,
    const int* __restrict__ lens, const long long* __restrict__ seed, float* __restrict__ o,
    float2* __restrict__ stats, int T, int H, float scale, Dropout drop) {
  __shared__ __align__(16) float ks[ROWS * D];
  __shared__ __align__(16) float vs[ROWS * D];
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + threadIdx.x;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int kend = row < T ? min(row + 1, len) : 0;            // this row's keys [0, kend)
  const int block_end = min(min(q0 + ROWS, T), len);           // the block's keys
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = qr[d] = 0.f;
  if (row < T) load_row(qr, q + head + (size_t)row * ld);
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < block_end; k0 += ROWS) {
    __syncthreads();  // the previous tile's reads are done
    load_tile(ks, k + head, ld, k0, block_end);
    load_tile(vs, v + head, ld, k0, block_end);
    __syncthreads();
    const int n = min(ROWS, kend - k0);  // this row's keys in the tile
    for (int j0 = 0; j0 < n; j0 += CHUNK) {
      float s[CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float dot = dot_row(qr, ks + (j0 + jj) * D);
        s[jj] = j0 + jj < n ? dot * scale : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      // key j0 is valid, so m_new is finite; exp(-inf) = 0 clears the
      // empty accumulator on the first chunk
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        float p = expf(s[jj] - m_new);
        l += p;
        if (DROP && j0 + jj < n) p *= keep_factor(key, row, k0 + j0 + jj, T, drop);
        axpy_row(acc, p, vs + (j0 + jj) * D);
      }
      m = m_new;
    }
  }
  if (row < T) {
    // a row with no valid key (len_b = 0) gives 0, as uniform weights over
    // the zeroed value rows do in the plain version
    store_row(o + ((size_t)b * T + row) * H * D + (size_t)h * D, acc, kend > 0 ? 1.f / l : 0.f);
    stats[((size_t)b * H + h) * T + row] = make_float2(m, l);
  }
}

}  // namespace
}  // namespace attention

// Launches the forward on `stream`; returns a cudaError_t (0 on success).
// q/k/v [B, T, H, head_dim] fp32 with rows `ld` floats apart, 16-byte
// aligned; lens int32 [B]; seed int64 [1] on the device (read only when
// dropout is on); o [B, T, H, head_dim] and stats [B, H, T, 2] are written.
// Dropout keeps an element when its draw is >= threshold and scales it by
// keep_scale.
extern "C" int attention_fwd(const float* q, const float* k, const float* v, int ld,
                             const int* lens, const long long* seed, float* o, float* stats, int B,
                             int T, int H, int head_dim, float scale, int dropout,
                             unsigned threshold, float keep_scale, void* stream) {
  using namespace attention;
  if (!valid_call(B, T, H, head_dim, ld)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  const Dropout drop{threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* st = reinterpret_cast<float2*>(stats);
  if (dropout)
    attention_fwd_kernel<true><<<grid, NT, 0, s>>>(q, k, v, ld, lens, seed, o, st, T, H, scale, drop);
  else
    attention_fwd_kernel<false><<<grid, NT, 0, s>>>(q, k, v, ld, lens, seed, o, st, T, H, scale, drop);
  return (int)cudaGetLastError();
}
