// Small-T causal attention recompute backward for Hopper (sm_90a), fp32,
// with the forward's dropout masks regenerated in-kernel.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/attention.py, function
// _vjp_bwd -> pallas_call(_bwd_kernel) (the custom VJP of fused_attention).
//
// What it computes, per sequence b, head h, over the valid pairs (r, c)
// (attention_common.cuh), with P recomputed from q, k and the forward's
// row statistics (m, l), and keep(r, c) the forward's dropout mask:
//   p      = exp((q_r . k_c) * scale - m_r) / l_r
//   dv_c   = sum_r p * keep * g_r
//   dp     = (g_r . v_c) * keep
//   ds     = p * (dp - delta_r) * scale,  delta_r = sum_c dp * p = g_r . o_r
//   dq_r   = sum_c ds * k_c,   dk_c = sum_r ds * q_r
// delta_r = g_r . o_r holds with dropout too, because o = P_drop V.
//
// What bounds it on an H100. The TPU program sums dK and dV over every
// query row inside one sequential grid step per sequence. On the card
// blocks run in no order, and float atomics would make two calls differ.
// A pair costs 96 FMAs for dq and 128 for dk/dv, plus a hash when dropping;
// as in the forward, arithmetic and shared-memory reads bound it.
//
// Design: two kernels, each one thread per row, 64 rows per block, so each
// sum is one thread's loop in a fixed order (no atomics; two calls are
// bitwise equal):
//   1. dq: one block per (query tile, head, sequence). A thread holds its
//      q and g rows and dq; it computes delta_r from its g and o rows and
//      stores it for kernel 2; K and V stream through shared memory over the
//      causal prefix, as in the forward.
//   2. dk/dv: one block per (key tile, head, sequence). A thread holds its
//      k and v rows and dk, dv; q, g, (m, l) and delta of the query rows
//      r >= the tile's first key stream through shared memory.
// Both recompute P. Residuals beyond the TPU kernel's (q, k, v, lens, seed):
// O and the forward's (m, l), see attention_fwd.cu.

#include "attention_common.cuh"

namespace attention {
namespace {

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, int ld,
    const float* __restrict__ o, const float2* __restrict__ stats, const int* __restrict__ lens,
    const long long* __restrict__ seed, const float* __restrict__ g, float* __restrict__ dq,
    float* __restrict__ delta, int T, int H, float scale, Dropout drop) {
  __shared__ __align__(16) float ks[ROWS * D];
  __shared__ __align__(16) float vs[ROWS * D];
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + threadIdx.x;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const size_t out_row = ((size_t)b * T + row) * H * D + (size_t)h * D;  // in o, g, dq
  const int kend = row < T ? min(row + 1, len) : 0;
  const int block_end = min(min(q0 + ROWS, T), len);
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  float qr[D], gr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = qr[d] = gr[d] = 0.f;
  float dl = 0.f, m = 0.f, inv_l = 0.f;
  if (row < T) {
    load_row(qr, q + head + (size_t)row * ld);
    load_row(gr, g + out_row);
    float orow[D];
    load_row(orow, o + out_row);
#pragma unroll
    for (int d = 0; d < D; ++d) dl = fmaf(gr[d], orow[d], dl);
    delta[((size_t)b * H + h) * T + row] = dl;
    const float2 st = stats[((size_t)b * H + h) * T + row];
    m = st.x;
    inv_l = kend > 0 ? 1.f / st.y : 0.f;
  }

  for (int k0 = 0; k0 < block_end; k0 += ROWS) {
    __syncthreads();
    load_tile(ks, k + head, ld, k0, block_end);
    load_tile(vs, v + head, ld, k0, block_end);
    __syncthreads();
    const int n = min(ROWS, kend - k0);
    for (int j = 0; j < n; ++j) {
      const float* kj = ks + j * D;
      const float p = expf(dot_row(qr, kj) * scale - m) * inv_l;
      float dp = dot_row(gr, vs + j * D);
      if (DROP) dp *= keep_factor(key, row, k0 + j, T, drop);
      axpy_row(acc, p * (dp - dl) * scale, kj);
    }
  }
  if (row < T) store_row(dq + out_row, acc, 1.f);
}

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, int ld,
    const float2* __restrict__ stats, const int* __restrict__ lens,
    const long long* __restrict__ seed, const float* __restrict__ g,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int T, int H,
    float scale, Dropout drop) {
  __shared__ __align__(16) float qs[ROWS * D];
  __shared__ __align__(16) float gs[ROWS * D];
  __shared__ float2 sts[ROWS];
  __shared__ float dls[ROWS];
  const int c0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int col = c0 + threadIdx.x;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const size_t head_rows = (size_t)b * T * H * D + (size_t)h * D;  // g's head, row stride H*D
  const size_t stat0 = ((size_t)b * H + h) * T;
  const bool active = col < len;  // a key at or past len_b is valid for no row
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) kr[d] = vr[d] = dka[d] = dva[d] = 0.f;
  if (active) {
    load_row(kr, k + head + (size_t)col * ld);
    load_row(vr, v + head + (size_t)col * ld);
  }

  // rows r >= c0 see the tile's keys (causal), and none does when c0 >= len_b
  for (int r0 = c0; c0 < len && r0 < T; r0 += ROWS) {
    __syncthreads();
    load_tile(qs, q + head, ld, r0, T);
    load_tile(gs, g + head_rows, H * D, r0, T);
    for (int i = threadIdx.x; i < ROWS; i += NT) {
      const bool in = r0 + i < T;
      sts[i] = in ? stats[stat0 + r0 + i] : make_float2(0.f, 1.f);
      dls[i] = in ? delta[stat0 + r0 + i] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int i_end = min(ROWS, T - r0);
    for (int i = max(col - r0, 0); i < i_end; ++i) {  // rows r = r0 + i >= col
      const float* qi = qs + i * D;
      const float* gi = gs + i * D;
      const float2 st = sts[i];
      const float p = expf(dot_row(kr, qi) * scale - st.x) * (1.f / st.y);
      const float keep = DROP ? keep_factor(key, r0 + i, col, T, drop) : 1.f;
      axpy_row(dva, DROP ? p * keep : p, gi);
      float dp = dot_row(vr, gi);
      if (DROP) dp *= keep;
      axpy_row(dka, p * (dp - dls[i]) * scale, qi);
    }
  }
  if (col < T) {
    const size_t out = ((size_t)b * T + col) * H * D + (size_t)h * D;
    store_row(dk + out, dka, 1.f);
    store_row(dv + out, dva, 1.f);
  }
}

template <bool DROP>
cudaError_t launch(const float* q, const float* k, const float* v, int ld, const float* o,
                   const float2* stats, const int* lens, const long long* seed, const float* g,
                   float* dq, float* dk, float* dv, float* delta, int B, int T, int H, float scale,
                   const Dropout& drop, cudaStream_t s) {
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  attention_bwd_dq_kernel<DROP><<<grid, NT, 0, s>>>(q, k, v, ld, o, stats, lens, seed, g, dq, delta,
                                                    T, H, scale, drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: kernel 2 reads the delta kernel 1 wrote
  attention_bwd_dkdv_kernel<DROP><<<grid, NT, 0, s>>>(q, k, v, ld, stats, lens, seed, g, delta, dk,
                                                      dv, T, H, scale, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace attention

// Launches both backward kernels on `stream`; returns a cudaError_t (0 on
// success). q/k/v as in attention_fwd; o and g contiguous
// [B, T, H, head_dim]; stats [B, H, T, 2] from the forward; dq/dk/dv
// contiguous [B, T, H, head_dim] and delta [B, H, T] (scratch) are written.
extern "C" int attention_bwd(const float* q, const float* k, const float* v, int ld, const float* o,
                             const float* stats, const int* lens, const long long* seed,
                             const float* g, float* dq, float* dk, float* dv, float* delta, int B,
                             int T, int H, int head_dim, float scale, int dropout,
                             unsigned threshold, float keep_scale, void* stream) {
  using namespace attention;
  if (!valid_call(B, T, H, head_dim, ld)) return (int)cudaErrorInvalidValue;
  const Dropout drop{threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* st = reinterpret_cast<const float2*>(stats);
  const cudaError_t err =
      dropout ? launch<true>(q, k, v, ld, o, st, lens, seed, g, dq, dk, dv, delta, B, T, H, scale, drop, s)
              : launch<false>(q, k, v, ld, o, st, lens, seed, g, dq, dk, dv, delta, B, T, H, scale, drop, s);
  return (int)err;
}
