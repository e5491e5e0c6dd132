// Small-T causal attention forward for Hopper (sm_90a), fp32 at its
// interface, products in 3xTF32 on the tensor cores (tf32_mma.cuh), with
// in-kernel dropout.
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
// (T=258, D=32) a (query, key) pair costs 64 FLOP of products (192 on the
// tensor cores in 3xTF32), an exp and, when dropping, a 32-bit hash,
// against 256 bytes of q, k, v and o per row, so the products and the
// latency of each block's serial walk over its key tiles bound it, not
// device memory.
//
// Design (FlashAttention-2's forward on the engine of attention_bwd.cu's dq
// kernel, attention_common.cuh): one block of 4 warps per (64-query tile,
// head, sequence), 640 blocks at B=8, T=258, H=16. A warp owns 16 query rows
// and holds them as split TF32 A fragments. K and V tiles of 64 keys are
// staged through shared memory by cp.async one tile ahead, over the block's
// causal prefix [0, min(last row + 1, len_b)), so any T runs in 36 KB of
// shared memory. Per tile a warp computes S = Q K^T by 3xTF32 MMAs
// (skipping the 8-key n-tiles wholly above its diagonal, past len_b or past
// T: warp-uniform tests), then the online softmax in the accumulators' own
// layout (row max and row sum over each quad by __shfl_xor_sync; the O
// accumulators rescaled once a tile), the dropout draw at each element's
// own (r, c), and O += P V with P fed back as the A operand (the permuted
// k-step of tf32_mma.cuh). Every product adds each k-step's three MMAs to
// its accumulators in fp32 (STEP_ADD): the tensor cores' accumulation
// truncates. S is attention_common.cuh's products_t, the backward's dq
// kernel's, in the same k-order (the backward keeps each S in one register).
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
  __shared__ __align__(16) float kv[2][2][ROWS * LDS];  // [stage][k, v]
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, qd = lane & 3;
  const int len = min(max(lens[b], 0), T);
  const size_t head = (size_t)b * T * ld + (size_t)h * D;
  const int HD = H * D;
  const size_t out_head = (size_t)b * T * HD + (size_t)h * D;  // in o
  const int block_end = min(min(q0 + ROWS, T), len);           // the block's keys [0, block_end)
  const int n_tiles = (block_end + ROWS - 1) / ROWS;
  const uint32_t key = DROP ? head_key(seed, b, h, H) : 0u;

  if (n_tiles > 0) {
    load_tile_async(kv[0][0], k + head, ld, 0, block_end);
    load_tile_async(kv[0][1], v + head, ld, 0, block_end);
  }
  tf32::cp_async_commit();

  // this warp's 16 rows: r_a = w0 + gr and r_b = r_a + 8
  const int w0 = q0 + 16 * warp;
  tf32::FragA qa[KSTEPS];
  load_frags(qa, q + head, ld, w0 + gr, T, qd);
  int kend[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = w0 + gr + 8 * e;
    kend[e] = row < T ? min(row + 1, len) : 0;  // this row's keys [0, kend)
  }
  // the warp's keys: [0, min(w0 + 16, len)) (rows past T have none)
  const int warp_end = w0 < T ? min(min(w0 + 16, T), len) : 0;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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
    const int j_end = min(8, max(0, (warp_end - k0 + 7) / 8));  // n-tiles with a key the warp sees
    if (j_end > 0) {
      float s[8][4];
      products_t<8, true>(s, qa, kv[st][0], 0, j_end, gr, qd);
      // scaled logits, -inf at invalid pairs (every n-tile at or past j_end
      // lies past both rows' kend); the tile's row max over each quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = k0 + 8 * j + 2 * qd + (e & 1);
          s[j][e] = col < kend[r] ? s[j][e] * scale : -INFINITY;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
      float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);
        // a row with no valid key yet keeps m = -inf, l = 0 and O = 0
        corr[r] = m_new[r] == -INFINITY ? 1.f : expf(m[r] - m_new[r]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool valid = s[j][e] != -INFINITY;
          float p = valid ? expf(s[j][e] - m_new[r]) : 0.f;
          sum[r] += p;
          if (DROP && valid) p *= keep_factor(key, w0 + gr + 8 * r, k0 + 8 * j + 2 * qd + (e & 1), T, drop);
          s[j][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
        m[r] = m_new[r];
      }
#pragma unroll
      for (int dn = 0; dn < KSTEPS; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] *= corr[e >> 1];
      products_acc<8, true>(acc, s, kv[st][1], 0, j_end, gr, qd);
    }
    __syncthreads();  // the next load overwrites this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + gr + 8 * r;
    if (row >= T) continue;
    // a row with no valid key (len_b = 0) gives 0, as uniform weights over
    // the zeroed value rows do in the plain version
    const float inv = kend[r] > 0 ? 1.f / l[r] : 0.f;
    float* dst = o + out_head + (size_t)row * HD + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < KSTEPS; ++dn)
      *reinterpret_cast<float2*>(dst + 8 * dn) = make_float2(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
    if (qd == 0) stats[((size_t)b * H + h) * T + row] = make_float2(m[r], l[r]);
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
