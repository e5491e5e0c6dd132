// Small-T causal attention recompute backward for Hopper (sm_90a), fp32 at
// its interface, products in 3xTF32 on the tensor cores (tf32_mma.cuh), with
// the forward's dropout masks regenerated in-kernel.
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
// What bounds it on an H100. A valid pair costs 5 products of D = 32
// multiply-adds (S, dP, dq, dk, dv; 320 FLOP), 960 tensor-core FLOP in
// 3xTF32, plus an exp and, when dropping, a 32-bit hash. At the LM's shapes
// ((8 and 64, 258), H = 16) that is 4-34 M pairs: a few microseconds at the
// 3xTF32 ceiling, so what bounds it is latency (640 blocks of a few tiles
// each at batch 8) and the exp/hash work on the CUDA cores, not device
// memory (6 [B, T, H, D] tensors in and out).
//
// Design (FlashAttention-2's backward, in two kernels so that no sum needs
// float atomics: each is one warp's MMA chain in a fixed order, so two calls
// are bitwise equal):
//   1. dq: one block of 4 warps per (64-query tile, head, sequence); a warp
//      owns 16 query rows and holds their q and g rows as split TF32 A
//      fragments. It writes delta_r = g_r . o_r for kernel 2, then walks the
//      key tiles of the block's causal prefix, staged through shared memory
//      by cp.async one tile ahead: S = Q K^T and dP = G V^T by MMA, p and ds
//      in the accumulators' own (row, column) layout (the dropout bits come
//      from the same counter r*T + c), then dQ += dS K with dS fed from the
//      accumulators as the A operand (the permuted k-step of tf32_mma.cuh).
//   2. dk/dv: one block per (64-key tile, head, sequence); a warp owns 16
//      keys and holds their k and v rows as A fragments, and walks the
//      query tiles at or after the diagonal (q, g, the row statistics and
//      delta staged one tile ahead): S^T = K Q^T and dP^T = V G^T, then
//      dV += (P keep)^T G and dK += dS^T Q.
// Warps skip the 8-column n-tiles that lie wholly above the diagonal, past
// len_b or past T (warp-uniform tests). The tile loads, fragments and
// products are attention_common.cuh's, shared with the forward. Residuals
// beyond the TPU kernel's (q, k, v, lens, seed): O and the forward's
// (m, l), see attention_fwd.cu.

#include "attention_common.cuh"

namespace attention {
namespace {

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, int ld,
    const float* __restrict__ o, const float2* __restrict__ stats, const int* __restrict__ lens,
    const long long* __restrict__ seed, const float* __restrict__ g, float* __restrict__ dq,
    float* __restrict__ delta, int T, int H, float scale, Dropout drop) {
  __shared__ __align__(16) float kv[2][2][ROWS * LDS];  // [stage][k, v]
  __shared__ float dls[ROWS];
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t out_head = (size_t)b * T * HD + (size_t)h * D;  // in o, g, dq
  const size_t stat0 = ((size_t)b * H + h) * T;
  const int block_end = min(min(q0 + ROWS, T), len);  // the block's keys [0, block_end)
  const int n_tiles = (block_end + ROWS - 1) / ROWS;
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  if (n_tiles > 0) {
    load_tile_async(kv[0][0], k + head, ld, 0, block_end);
    load_tile_async(kv[0][1], v + head, ld, 0, block_end);
  }
  tf32::cp_async_commit();

  // delta_r = g_r . o_r, in the order of the plain loop
  if (threadIdx.x < ROWS) {
    const int row = q0 + threadIdx.x;
    float dl = 0.f;
    if (row < T) {
      const float* gp = g + out_head + (size_t)row * HD;
      const float* op = o + out_head + (size_t)row * HD;
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(gp) + c);
        const float4 ov = __ldg(reinterpret_cast<const float4*>(op) + c);
        dl = fmaf(gv.x, ov.x, dl);
        dl = fmaf(gv.y, ov.y, dl);
        dl = fmaf(gv.z, ov.z, dl);
        dl = fmaf(gv.w, ov.w, dl);
      }
      delta[stat0 + row] = dl;
    }
    dls[threadIdx.x] = dl;
  }

  // this warp's 16 rows: r_a = w0 + gr and r_b = r_a + 8
  const int w0 = q0 + 16 * warp;
  tf32::FragA qa[KSTEPS], ga[KSTEPS];
  load_frags(qa, q + head, ld, w0 + gr, T, qd);
  load_frags(ga, g + out_head, HD, w0 + gr, T, qd);
  float m[2], il[2];
  int kend[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = w0 + gr + 8 * e;
    const float2 st = row < T ? stats[stat0 + row] : make_float2(0.f, 1.f);
    m[e] = st.x;
    il[e] = 1.f / st.y;
    kend[e] = row < T ? min(row + 1, len) : 0;  // this row's keys [0, kend)
  }
  // the warp's keys: [0, min(w0 + 16, len)) (rows past T have none)
  const int warp_end = w0 < T ? min(min(w0 + 16, T), len) : 0;
  __syncthreads();  // dls
  const float dl[2] = {dls[16 * warp + gr], dls[16 * warp + gr + 8]};

  float acc[KSTEPS][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = it * ROWS;
    if (it + 1 < n_tiles) {
      load_tile_async(kv[st ^ 1][0], k + head, ld, k0 + ROWS, block_end);
      load_tile_async(kv[st ^ 1][1], v + head, ld, k0 + ROWS, block_end);
      tf32::cp_async_commit();
      tf32::cp_async_wait<1>();
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kv[st][0];
    const float* vs = kv[st][1];
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));  // n-tiles with a key the warp sees
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j0 = 4 * half;
      if (j0 >= j_end) break;
      float s[4][4], dp[4][4];
      products_t(s, qa, ks, j0, j_end, gr, qd);
      products_t(dp, ga, vs, j0, j_end, gr, qd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int row = w0 + gr + 8 * r;
          const int col = k0 + 8 * (j0 + j) + 2 * qd + (e & 1);
          const bool valid = col < kend[r];
          const float p = valid ? expf(s[j][e] * scale - m[r]) * il[r] : 0.f;
          float d = dp[j][e];
          if (DROP) d *= valid ? keep_factor(key, row, col, T, drop) : 0.f;
          s[j][e] = p * (d - dl[r]) * scale;  // ds
        }
      products_acc(acc, s, ks, j0, j_end, gr, qd);
    }
    __syncthreads();  // the next load overwrites this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gr + 8 * r;
    if (row >= T) continue;
    float* dst = dq + out_head + (size_t)row * HD + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < KSTEPS; ++dn)
      *reinterpret_cast<float2*>(dst + 8 * dn) = make_float2(acc[dn][2 * r], acc[dn][2 * r + 1]);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(NT) attention_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, int ld,
    const float2* __restrict__ stats, const int* __restrict__ lens,
    const long long* __restrict__ seed, const float* __restrict__ g,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int T, int H,
    float scale, Dropout drop) {
  __shared__ __align__(16) float qg[2][2][ROWS * LDS];  // [stage][q, g]
  __shared__ float sm[2][3][ROWS];                      // [stage][m, 1/l, delta]
  const int c0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t head_rows = (size_t)b * T * HD + (size_t)h * D;  // in g, dk, dv
  const size_t stat0 = ((size_t)b * H + h) * T;
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;
  // query rows r >= c0 see the tile's keys (causal); none does when c0 >= len_b
  const int n_tiles = c0 < len ? (T - c0 + ROWS - 1) / ROWS : 0;

  auto stage_tile = [&](int st, int r0) {
    load_tile_async(qg[st][0], q + head, ld, r0, T);
    load_tile_async(qg[st][1], g + head_rows, HD, r0, T);
    tf32::cp_async_commit();
    if (threadIdx.x < ROWS) {
      const int r = r0 + threadIdx.x;
      const float2 s2 = r < T ? stats[stat0 + r] : make_float2(0.f, 1.f);
      sm[st][0][threadIdx.x] = s2.x;
      sm[st][1][threadIdx.x] = 1.f / s2.y;
      sm[st][2][threadIdx.x] = r < T ? delta[stat0 + r] : 0.f;
    }
  };
  if (n_tiles > 0) stage_tile(0, c0);

  // this warp's 16 keys: c_a = w0 + gr and c_b = c_a + 8
  const int w0 = c0 + 16 * warp;
  tf32::FragA ka[KSTEPS], va[KSTEPS];
  load_frags(ka, k + head, ld, w0 + gr, T, qd);
  load_frags(va, v + head, ld, w0 + gr, T, qd);
  const bool warp_active = w0 < len;  // a key at or past len_b is valid for no row

  float dka[KSTEPS][4] = {}, dva[KSTEPS][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, r0 = c0 + it * ROWS;
    if (it + 1 < n_tiles) {
      stage_tile(st ^ 1, r0 + ROWS);
      tf32::cp_async_wait<1>();
    } else {
      tf32::cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = qg[st][0];
    const float* gs = qg[st][1];
    // n-tiles of queries that reach the warp's keys (r >= w0) and lie before T
    const int j_begin = warp_active ? max(0, (w0 - r0) / 8) : 8;
    const int j_end = min(8, (T - r0 + 7) / 8);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j0 = 4 * half;
      if (j0 + 4 <= j_begin || j0 >= j_end) continue;
      float s[4][4], dp[4][4];
      products_t(s, ka, qs, j0, j_end, gr, qd);
      products_t(dp, va, gs, j0, j_end, gr, qd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = w0 + gr + 8 * (e >> 1);  // the key
          const int i = 8 * (j0 + j) + 2 * qd + (e & 1);
          const int row = r0 + i;  // the query
          const bool valid = col <= row && col < len && row < T;
          const float p = valid ? expf(s[j][e] * scale - sm[st][0][i]) * sm[st][1][i] : 0.f;
          const float keep = DROP ? (valid ? keep_factor(key, row, col, T, drop) : 0.f) : 1.f;
          const float d = DROP ? dp[j][e] * keep : dp[j][e];
          dp[j][e] = DROP ? p * keep : p;                    // P keep, for dV
          s[j][e] = p * (d - sm[st][2][i]) * scale;          // dS, for dK
        }
      products_acc(dva, dp, gs, j0, j_end, gr, qd);
      products_acc(dka, s, qs, j0, j_end, gr, qd);
    }
    __syncthreads();  // the next load overwrites this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = w0 + gr + 8 * r;
    if (col >= T) continue;
    const size_t out = head_rows + (size_t)col * HD + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < KSTEPS; ++dn) {
      *reinterpret_cast<float2*>(dk + out + 8 * dn) = make_float2(dka[dn][2 * r], dka[dn][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + out + 8 * dn) = make_float2(dva[dn][2 * r], dva[dn][2 * r + 1]);
    }
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
