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
// vector step over t_x tokens with a block-wide barrier, and then t_y
// serial backtrack steps. The bytes are small (value and mask read once,
// the path written once: 18.9 MB at [8, 256, 768], 6 us of HBM time), and
// so are the operations.
//
// Design: one block per sequence, one thread per token (a loop over tokens
// when t_x > 1024). The DP row v lives in a double buffer in shared memory,
// so one barrier per frame suffices. The "stay" decisions and the mask are
// kept as bits in shared memory (each warp's decisions for one frame are
// one __ballot_sync word): t_y x t_x bits each, 24 KB at 768 x 256, 64 KB
// at 1024 x 512, so the dynamic shared-memory limit is raised (2 x 64 KB
// of bits + 37 KB of tiles at 1024 x 512). value * mask and the mask are
// staged in shared memory FRAME_CHUNK frames at a time, read along the
// frame axis. The
// path is first zeroed by the whole block, then one thread walks back
// through the bits and writes the ones. value * mask and the add are
// __fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA and the
// rounding equals the plain version's two separate operations.

#include <cuda_runtime.h>
#include <cstdint>

namespace mas {

constexpr int FRAME_CHUNK = 8;   // frames staged per tile
constexpr float MAX_NEG = -1e9f;

__host__ __device__ inline int words(int t_x) { return (t_x + 31) / 32; }

inline size_t smem_bytes(int t_x, int t_y) {
  return sizeof(float) * ((size_t)2 * words(t_x) * t_y + 2 * (size_t)t_x +
                          (size_t)2 * t_x * (FRAME_CHUNK + 1));
}

__global__ void mas_kernel(const float* __restrict__ value, const float* __restrict__ mask,
                           float* __restrict__ path, int t_x, int t_y) {
  extern __shared__ float smem[];
  const int W = words(t_x);
  uint32_t* stay_bits = reinterpret_cast<uint32_t*>(smem);   // [t_y][W]
  uint32_t* mask_bits = stay_bits + (size_t)W * t_y;         // [t_y][W]
  float* v = reinterpret_cast<float*>(mask_bits + (size_t)W * t_y);  // [2][t_x]
  float* tile = v + 2 * t_x;                                  // [t_x][FRAME_CHUNK + 1]: value * mask
  float* tile_mask = tile + (size_t)t_x * (FRAME_CHUNK + 1);  // the same frames' mask

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t base = (size_t)b * t_x * t_y;
  const float* val = value + base;
  const float* msk = mask + base;
  float* out = path + base;

  for (int i = tid; i < t_x; i += nt) v[i] = 0.0f;
  int cur = 0;
  for (int j0 = 0; j0 < t_y; j0 += FRAME_CHUNK) {
    const int n = min(FRAME_CHUNK, t_y - j0);
    __syncthreads();
    for (int e = tid; e < t_x * FRAME_CHUNK; e += nt) {
      const int i = e / FRAME_CHUNK, jj = e % FRAME_CHUNK;
      if (jj < n) {
        const size_t g = (size_t)i * t_y + j0 + jj;
        const float m = msk[g];
        tile[i * (FRAME_CHUNK + 1) + jj] = __fmul_rn(val[g], m);
        tile_mask[i * (FRAME_CHUNK + 1) + jj] = m;
      }
    }
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      const int j = j0 + jj;
      const float* vc = v + cur * t_x;
      float* vn = v + (cur ^ 1) * t_x;
      for (int i0 = 0; i0 < t_x; i0 += nt) {
        const int i = i0 + tid;
        const bool active = i < t_x;
        bool stay = false, inside = false;
        if (active) {
          const float vi = vc[i];
          const float vp = i > 0 ? vc[i - 1] : MAX_NEG;
          stay = vi >= vp;
          const float vmax = stay ? vi : vp;
          vn[i] = i <= j ? __fadd_rn(vmax, tile[i * (FRAME_CHUNK + 1) + jj]) : MAX_NEG;
          inside = tile_mask[i * (FRAME_CHUNK + 1) + jj] > 0.0f;
        }
        const uint32_t s = __ballot_sync(0xffffffffu, stay);
        const uint32_t m = __ballot_sync(0xffffffffu, inside);
        const int w = i / 32;
        if (lane == 0 && w < W) {
          stay_bits[(size_t)j * W + w] = s;
          mask_bits[(size_t)j * W + w] = m;
        }
      }
      cur ^= 1;
      __syncthreads();
    }
  }

  // zero the path, then one thread writes the ones
  for (size_t e = tid; e < (size_t)t_x * t_y; e += nt) out[e] = 0.0f;
  __syncthreads();
  if (tid == 0) {
    int idx = -1;
    for (int w = 0; w < W; ++w) idx += __popc(mask_bits[w]);
    for (int j = t_y - 1; j >= 0; --j) {
      int step = 0;
      if (idx >= 0) {
        const uint32_t bit = 1u << (idx & 31);
        const bool inside = mask_bits[(size_t)j * W + idx / 32] & bit;
        if (inside) out[(size_t)idx * t_y + j] = 1.0f;
        step = inside ? ((stay_bits[(size_t)j * W + idx / 32] & bit) ? 1 : 0) : 1;
      }
      idx += step - 1;
    }
  }
}

}  // namespace mas

extern "C" long mas_smem_bytes(int t_x, int t_y) { return (long)mas::smem_bytes(t_x, t_y); }

extern "C" int mas_forward(const float* value, const float* mask, float* path, int B, int t_x,
                           int t_y, void* stream) {
  if (B < 1 || t_x < 1 || t_y < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = mas::smem_bytes(t_x, t_y);
  cudaError_t err = cudaFuncSetAttribute(mas::mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = t_x >= 1024 ? 1024 : ((t_x + 31) / 32) * 32;
  mas::mas_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(value, mask, path, t_x, t_y);
  return (int)cudaGetLastError();
}
