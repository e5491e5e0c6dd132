// Monotonic alignment search (Viterbi DP and backtrack) for Hopper (sm_90a).
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/mas.py, function
// maximum_path_pallas -> pallas_call(_mas_kernel). Semantics in
// ops/mas.py; the plain version there is ops/mas.py:maximum_path, and the
// two agree bit for bit.
//
// What it computes, per sequence b (value, mask, path: [B, t_x, t_y]):
//   v_j[i] = (i <= j) ? max(v_{j-1}[i], v_{j-1}[i-1]) + value[i, j] * mask[i, j] : -1e9
//   stay_j[i] = v_{j-1}[i] >= v_{j-1}[i-1]      (v_{-1} = 0, v[-1] = -1e9)
// then a walk back from token sum(mask[:, 0]) - 1 at the last frame.
//
// What bounds it on an H100: the DP's serial depth of t_y frames, each a
// vector step over t_x tokens, and then t_y serial backtrack steps. The
// bytes are small (value and mask read once, the path written once: 18.9 MB
// at [8, 256, 768], 6 us of HBM time), and so are the operations, so the
// latency of one frame's step sets the time.
//
// Design: one block per sequence; every barrier and every device-memory
// read is kept off the serial chain.
//   * The chain: warp 0 runs the DP in registers. Lane L holds tokens
//     L + 32k for k < KW (KW, a template parameter, the power of two at or
//     above ceil(t_x / 32), so t_x <= 1024). Each frame a lane takes the
//     token below each of its tokens from lane L - 1 by one __shfl_sync a
//     register (lane 0 takes lane 31's previous register, token 0 -1e9), and
//     one __ballot_sync a register gives a word of 32 steps of the
//     backtrack, dir = stay | outside the mask, word k covering tokens
//     32k..32k+31, stored to [t_y][KW] in shared memory by every lane (no
//     divergent branch). A frame's (value * mask, mask) pairs are loaded
//     beside the shuffles, one 8-byte load a register; the max is fmaxf and
//     the i <= j select bitwise, so that no predicate but the ballots' is
//     live and the registers' chains interleave; the frames at or past
//     token 32 KW - 1 skip the select. The block has 12 warps, of which 4, 8
//     and 11 do nothing until the DP ends, so that the chain has its warp
//     scheduler to itself (a warp's scheduler is its index mod 4).
//   * Producers: 8 other warps stage (__fmul_rn(value, mask), mask) pairs
//     for chunks of C frames into a ring of NBUF shared-memory stages ahead
//     of the chain. Their loads run along the frames (a warp covers 32 / C
//     tokens' runs of C frames) and are issued one chunk ahead into a second
//     set of registers, before the wait for a free stage. A chunk is handed
//     over by one named barrier each way (bar.arrive / bar.sync), not one a
//     frame. Between chunks they zero a slice of the path.
//   * Backtrack: one lane walks back in windows of 32 frames: over 32
//     frames the token moves down by at most 32, so each frame's two
//     candidate words are loaded as one 64-bit word for the window at once
//     and the walk runs in registers, three dependent instructions a frame.
//     It records the token of each frame; then the whole block writes the
//     ones where the mask is set.
// value * mask and the add are __fmul_rn / __fadd_rn, so nvcc cannot
// contract them into an FMA and the rounding equals the plain version's two
// separate operations; ties stay, as there.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace mas {

constexpr float MAX_NEG = -1e9f;
constexpr int MAX_TX = 1024;     // 32 tokens a lane
constexpr int PRODUCERS = 8;     // producer warps a block: 1-3, 5-7, 9 and 10
constexpr int NBUF = 3;          // ring stages: the producers run up to two chunks ahead
constexpr int NT = 32 * 12;                // warps 4, 8 and 11 idle during the DP
constexpr int NB = 32 * (1 + PRODUCERS);   // the threads of the full and empty barriers
constexpr int MAX_SMEM = 232448;  // dynamic shared memory one H100 block may use
constexpr unsigned ALL = 0xffffffffu;

// frames a chunk: C x KW = 128 up to KW = 8 (at most 32 frames), 64 past
// it, so a stage is 16-33 KB
__host__ __device__ constexpr int chunk(int kw) { return kw >= 16 ? 64 / kw : (kw <= 4 ? 32 : 128 / kw); }

// a frame's row of (value * mask, mask) pairs in a stage: 32 KW, padded so
// that the producers' 8-byte stores (a half-warp: 16 / C tokens x C frames)
// fall on distinct bank pairs
__host__ __device__ constexpr int tok_stride(int kw) { return 32 * kw + (chunk(kw) >= 16 ? 1 : 16 / chunk(kw)); }

// 4-byte words of one ring stage: float2 [C][TOKP]
__host__ __device__ constexpr int stage_words(int kw) { return 2 * chunk(kw) * tok_stride(kw); }

inline int kw_of(int t_x) {
  int kw = 1;
  while (32 * kw < t_x) kw *= 2;
  return kw;
}

// the ring, the dir words [t_y][KW] and each frame's token [t_y]
inline size_t smem_bytes(int kw, int t_y) {
  return 4 * ((size_t)NBUF * stage_words(kw) + (size_t)t_y * kw + t_y);
}

__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(NB) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(NB) : "memory");
}
// named barriers: stage s is full (producers arrive, the chain waits) and
// empty (the chain arrives, the producers wait); 0 is __syncthreads'
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + NBUF + s; }

template <int KW>
__global__ void __launch_bounds__(NT) mas_kernel(const float* __restrict__ value, const float* __restrict__ mask,
                                                 float* __restrict__ path, int t_x, int t_y) {
  constexpr int C = chunk(KW), TOKP = tok_stride(KW), STAGE = stage_words(KW);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* dir = smem + NBUF * STAGE;                          // [t_y][KW]
  int* track = reinterpret_cast<int*>(dir + (size_t)t_y * KW);  // [t_y]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)blockIdx.x * t_x * t_y;
  const int n_chunks = (t_y + C - 1) / C;
  int start = -1;  // the backtrack's first token (warp 0)

  if (warp == 0) {
    float v[KW];
#pragma unroll
    for (int k = 0; k < KW; ++k) v[k] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % NBUF, j0 = c * C, n = min(C, t_y - j0);
      bar_sync(full_bar(s));
      const float2* vm = reinterpret_cast<const float2*>(smem + s * STAGE);
      if (c == 0) {  // sum(mask[:, 0] > 0) - 1
        int count = 0;
#pragma unroll
        for (int k = 0; k < KW; ++k) count += __popc(__ballot_sync(ALL, vm[32 * k + lane].y > 0.f));
        start = count - 1;
      }
      auto frame = [&](int jj, auto all_active) {
        const int j = j0 + jj;
        const float2* add = vm + jj * TOKP + lane;
        float x[KW];
        float2 cur[KW];
        uint32_t dir_w[KW];
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          cur[k] = add[32 * k];
          x[k] = __shfl_sync(ALL, v[k], (lane + 31) & 31);
        }
        // no predicate lives past its ballot: the max is fmaxf (equal to the
        // plain version's select but for the sign of a zero, which no
        // comparison or later sum sees), and the i <= j select is bitwise
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          const float below = lane ? x[k] : (k ? x[k - 1] : MAX_NEG);
          dir_w[k] = __ballot_sync(ALL, v[k] >= below || !(cur[k].y > 0.f));  // stay, or outside the mask
          const float sum = __fadd_rn(fmaxf(v[k], below), cur[k].x);
          if constexpr (decltype(all_active)::value) {
            v[k] = sum;
          } else {
            const int before = (j - 32 * k - lane) >> 31;  // all ones while token 32k + lane > j
            v[k] = __int_as_float((__float_as_int(sum) & ~before) | (__float_as_int(MAX_NEG) & before));
          }
        }
        // every lane stores the same words (no divergent branch on the chain)
        uint32_t* dst = dir + (size_t)j * KW;
        if constexpr (KW >= 4) {
#pragma unroll
          for (int k = 0; k < KW; k += 4)
            *reinterpret_cast<uint4*>(dst + k) = make_uint4(dir_w[k], dir_w[k + 1], dir_w[k + 2], dir_w[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < KW; ++k) dst[k] = dir_w[k];
        }
      };
      // frames before `split` still have tokens past j (v = -1e9 there)
      const int split = min(max(32 * KW - 1 - j0, 0), n);
      int jj = 0;
#pragma unroll 1
      for (; jj < split; ++jj) frame(jj, std::false_type{});
#pragma unroll 1
      for (; jj < n; ++jj) frame(jj, std::true_type{});
      if (c + NBUF < n_chunks) bar_arrive(empty_bar(s));  // a producer refills this stage
    }
  } else if (warp % 4 != 0 && warp - 1 - (warp >> 2) < PRODUCERS) {
    // a producer thread's elements of a chunk: frame jj = pt % C of rows
    // pt / C + (PT / C) u, so a warp's load covers 32 / C whole runs of C
    // frames (coalesced), and its stores land on distinct banks (TOKP)
    constexpr int PT = 32 * PRODUCERS, ITER = 32 * KW * C / PT;
    const int pw = warp - 1 - (warp >> 2), pt = 32 * pw + lane, jj = pt % C, i0 = pt / C;
    // the path is zeroed a slice a chunk, in 16-byte stores but for the
    // sequence's unaligned ends
    const size_t cells = (size_t)t_x * t_y, lo = (base + 3) & ~(size_t)3, hi = (base + cells) & ~(size_t)3;
    const int n4 = hi > lo ? (int)((hi - lo) / 4) : 0, per4 = (n4 + n_chunks - 1) / n_chunks;
    float4* zero4 = reinterpret_cast<float4*>(path + lo);
    if (pt < 4 && base + pt < lo && base + pt < base + cells) path[base + pt] = 0.f;
    const size_t tail = hi > lo ? hi : lo;
    if (pt < 4 && tail + pt < base + cells) path[tail + pt] = 0.f;
    auto load = [&](int c, float (&val)[ITER], float (&msk)[ITER]) {
      const int j = c * C + jj;
#pragma unroll
      for (int u = 0; u < ITER; ++u) {
        const int i = i0 + (PT / C) * u;
        const bool in = i < t_x && j < t_y;
        const size_t g = base + (size_t)(in ? i : 0) * t_y + (in ? j : 0);
        val[u] = in ? __ldg(value + g) : 0.f;
        msk[u] = in ? __ldg(mask + g) : 0.f;
      }
    };
    auto produce = [&](int c, const float (&val)[ITER], const float (&msk)[ITER]) {
      const int s = c % NBUF;
      float2* vm = reinterpret_cast<float2*>(smem + s * STAGE);
      if (c >= NBUF) bar_sync(empty_bar(s));  // the chain is done with the stage
#pragma unroll
      for (int u = 0; u < ITER; ++u)  // every slot of the stage is written, zeros past t_x
        vm[jj * TOKP + i0 + (PT / C) * u] = make_float2(__fmul_rn(val[u], msk[u]), msk[u]);
      bar_arrive(full_bar(s));
      const int q1 = min((c + 1) * per4, n4);
      for (int q = c * per4 + pt; q < q1; q += PT) zero4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    };
    // two register sets in turns, so that a chunk's loads are in flight while
    // the one before is stored and the wait for its stage runs (no copy
    // between the sets, which would wait for the loads just issued)
    float val_a[ITER], msk_a[ITER], val_b[ITER], msk_b[ITER];
    load(0, val_a, msk_a);
    for (int c = 0; c < n_chunks; c += 2) {
      if (c + 1 < n_chunks) load(c + 1, val_b, msk_b);
      produce(c, val_a, msk_a);
      if (c + 1 >= n_chunks) break;
      if (c + 2 < n_chunks) load(c + 2, val_a, msk_a);
      produce(c + 1, val_b, msk_b);
    }
  }
  __syncthreads();  // the dir words are complete and the path is zero

  if (threadIdx.x == 0) {
    // A window of (at most) 32 frames: the token moves down by at most 32,
    // so its two candidate words of each frame, word hi = idx / 32 and the
    // one below, are loaded as one 64-bit word at once, and the walk runs on
    // the bit position p = idx - 32 (hi - 1) in registers. A token below 0
    // marks nothing, and since a step never moves it up, it stays below 0
    // whatever bit the masked shift reads.
    int idx = start;
    auto window = [&](int j, int n, auto whole) {
      const int hi = max(idx, 0) >> 5;
      unsigned long long w[32];
#pragma unroll
      for (int s = 0; s < 32; ++s)
        if (decltype(whole)::value || s < n) {
          const uint32_t* row = dir + (size_t)(j - s) * KW;
          w[s] = (unsigned long long)row[hi] << 32 | (hi ? row[hi - 1] : 0u);
        }
      int p = idx - 32 * (hi - 1);
#pragma unroll
      for (int s = 0; s < 32; ++s)
        if (decltype(whole)::value || s < n) {
          track[j - s] = p + 32 * (hi - 1);
          p += (int)((w[s] >> (p & 63)) & 1ull) - 1;
        }
      idx = p + 32 * (hi - 1);
    };
    int j = t_y - 1;
    for (; j >= 31; j -= 32) window(j, 32, std::true_type{});
    if (j >= 0) window(j, j + 1, std::false_type{});
  }
  __syncthreads();
  for (int j = threadIdx.x; j < t_y; j += NT) {
    const int idx = track[j];
    if (idx >= 0) {
      const size_t e = base + (size_t)idx * t_y + j;
      if (mask[e] > 0.f) path[e] = 1.f;
    }
  }
}

template <int KW>
cudaError_t launch(const float* value, const float* mask, float* path, int B, int t_x, int t_y,
                   cudaStream_t stream) {
  // once an instance: the kernel may take any dynamic shared memory a block has
  static const cudaError_t attr =
      cudaFuncSetAttribute(mas_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  mas_kernel<KW><<<B, NT, smem_bytes(KW, t_y), stream>>>(value, mask, path, t_x, t_y);
  return cudaGetLastError();
}

}  // namespace mas

// Shared memory a launch at (t_x, t_y) needs, or -1 past t_x = 1024.
extern "C" long mas_smem_bytes(int t_x, int t_y) {
  if (t_x < 1 || t_x > mas::MAX_TX || t_y < 1) return -1;
  return (long)mas::smem_bytes(mas::kw_of(t_x), t_y);
}

// Launches MAS on `stream`; returns a cudaError_t (0 on success). value and
// mask [B, t_x, t_y] fp32 contiguous; path [B, t_x, t_y] is written.
extern "C" int mas_forward(const float* value, const float* mask, float* path, int B, int t_x,
                           int t_y, void* stream) {
  const long smem = mas_smem_bytes(t_x, t_y);
  if (B < 1 || smem < 0 || smem > mas::MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mas::kw_of(t_x)) {
    case 1: return (int)mas::launch<1>(value, mask, path, B, t_x, t_y, s);
    case 2: return (int)mas::launch<2>(value, mask, path, B, t_x, t_y, s);
    case 4: return (int)mas::launch<4>(value, mask, path, B, t_x, t_y, s);
    case 8: return (int)mas::launch<8>(value, mask, path, B, t_x, t_y, s);
    case 16: return (int)mas::launch<16>(value, mask, path, B, t_x, t_y, s);
    default: return (int)mas::launch<32>(value, mask, path, B, t_x, t_y, s);
  }
}
