// GatedHiFi block forward for Hopper (sm_90a) in fp32, with in-kernel
// dropout, its products in 3xTF32 on the tensor cores (tf32_mma.cuh). The
// bf16 mode is gated_hifi_fwd_bf16.cu (TMA and wgmma).
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/gated_hifi.py, function
// fused_gated_hifi -> _fwd -> _fwd_kernel (the TPU kernel's forward) with
// dot_dtype fp32, and its dropout (_branch_masks, _mix). The backward is
// gated_hifi_bwd.cu.
//
// What it computes, per sequence b and frame t (x pre-masked, H = 2W):
//   z_d   = x W_d + b_d                       (4 branch 1x1 expands)
//   a_d   = relu(z_d) * m0_d, zero outside [0, T)  (the convs' zero padding)
//   c_d   = dilated_conv_d(a_d) + cb_d        (kernel k_d, dilation dil_d)
//   zp_d  = z_d + scale * ((relu(c_d) * m1_d) W1_d + b1_d)
//   u     = sum_d tanh(zp_d[:, :W]) * softmax_d(zp_d[:, W:])
//   out   = (x + scale * (u Wg + bg)) * [t < min(T, lens[b])]
// m0_d and m1_d are the dropout masks (gated_hifi_common.cuh); with p = 0
// no stage computes a hash.
//
// What bounds it on an H100: arithmetic. At W=64, H=128 and kernels
// (3,5,7,9) a frame costs about 1.06 MFLOP (the dilated convs 74% of it),
// 3x that on the tensor cores in 3xTF32, against about 10 KB of device
// memory the stages move (a, h1 and zp written and read back, x twice):
// at 16 x 33024 frames 1.7 ms of bytes at 3.35 TB/s against 3.4 ms of
// 3xTF32 products at 495 TF/s.
//
// Design: the TPU kernel holds the centre and the halo of every branch in
// VMEM. Here that window (branch 4's 280 frames of x and of the expand)
// took 217 KB, one block of 8 warps per SM, and its products ran as fp32
// FMA on the CUDA cores (67 TF/s). Now the forward runs the backward's
// recompute stages (gated_hifi_tiles.cuh: expand, conv, branch; each conv
// tap a shifted k-slice, so no halo and any dilation) on the tensor cores,
// two 80 KB blocks per SM, each k-step's MMAs added to the accumulators in
// fp32 (RN, see gated_hifi_tiles.cuh), and ends with its own output stage:
//   4 out   u from zp (Mix, the backward's gate formula), u Wg, residual,
//           length mask, exact zeros past min(T, len)
// The wrapper passes two [B, T, depth*H] scratch buffers: a (stage 1),
// which stage 3 overwrites with zp once stage 2 has read it, and h1.

#include "gated_hifi_tiles.cuh"

namespace gated_hifi {
namespace {

// The output stage's u tile: rows padded to 68 floats so that 3xTF32's
// scalar fragment reads fall on distinct banks
template <class IO>
struct OutTile {
  static constexpr int LDU = W + 4;
  static constexpr size_t SMEM = sizeof(IO) * (TT * LDU + W * TileShape<W>::LDB);
};

// 4. out = (x + scale * (u Wg + bg)) * [t < min(T, len)], u from zp (in dzp):
// the [64 x W] u tile in shared memory, then one 64-deep product with Wg
template <class IO>
__global__ void __launch_bounds__(NT, 2) tile_out_kernel(const Args<IO> p) {
  TILE_PROLOGUE;
  using S = TileShape<W>;
  constexpr int LDU = OutTile<IO>::LDU, E = 16 / sizeof(IO);
  IO* us = reinterpret_cast<IO*>(smem);  // [TT][LDU]
  IO* ws = us + TT * LDU;                // [W][LDB]: Wg (in, out)
  for (int f = threadIdx.x; f < W * (W / E); f += NT) {
    const int r = f / (W / E), c = f % (W / E);
    tf32::cp_async16(ws + r * S::LDB + E * c, p.wg + (size_t)r * W + E * c, 16);
  }
  tf32::cp_async_commit();
  for (int f = threadIdx.x; f < TT * (W / 2); f += NT) {
    const int r = f / (W / 2), c = 2 * (f % (W / 2));
    const int t = t0 + r;
    float u0 = 0.f, u1 = 0.f;
    if (t < T) {
      Mix mx;
      mix(mx, p.dzp + (row0 + t) * ldw + c, p.br.depth);
      u0 = mx.u[0];
      u1 = mx.u[1];
    }
    st2(us + r * LDU + c, u0, u1);
  }
  tf32::cp_async_wait<0>();
  __syncthreads();
  const WarpTile<W> wt;
  float acc[S::MT][4][4] = {};
  mma_tile<W, W, LDU, true>(acc, us, ws, wt);
  const int len = min(T, p.lens[b]);
  for_pairs<W>(acc, [&](int r, int c, float v0, float v1) {
    const int t = t0 + r;
    if (t >= T) return;
    float2 o = make_float2(0.f, 0.f);
    if (t < len) {
      const float2 xv = ld2(p.x + (row0 + t) * W + c);
      o = make_float2(xv.x + p.scale * (v0 + f32(p.bg[c])), xv.y + p.scale * (v1 + f32(p.bg[c + 1])));
    }
    st2(p.out + (row0 + t) * W + c, o.x, o.y);
  });
}

int forward(const float* x, const int* lens, const float* wall, const float* ball, const float* ks,
            const float* cb, const float* w1, const float* b1, const float* wg, const float* bg, float* a,
            float* h1, float* out, int B, int T, int width, int depth, const int* kernels, const int* dilations,
            float scale, unsigned seed, unsigned threshold, float keep_scale, void* stream) {
  Args<float> p{};
  if (width != W || B < 1 || B > 65535 || T < 1 || !make_branches(depth, kernels, dilations, &p.br))
    return (int)cudaErrorInvalidValue;
  p.x = x;
  p.lens = lens;
  p.wall = wall;
  p.ball = ball;
  p.ks = ks;
  p.cb = cb;
  p.w1 = w1;
  p.b1 = b1;
  p.wg = wg;
  p.bg = bg;
  p.a = a;
  p.h1 = h1;
  p.dzp = a;  // zp over a: stage 2 has read a for every branch before stage 3 starts
  p.out = out;
  p.T = T;
  p.scale = scale;
  p.keep = threshold ? keep_scale : 1.f;
  p.drop = Dropout{seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr size_t smem = Staging<H, float, float>::SMEM;
  // in stream order: each stage reads what the ones before it wrote
  cudaError_t err = launch_stage(tile_expand_kernel<true, float>, smem, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage(tile_conv_kernel<true, float>, smem, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage(tile_branch_kernel<true, float>, smem, p, B, depth, s);
  if (err == cudaSuccess) err = launch_stage(tile_out_kernel<float>, OutTile<float>::SMEM, p, B, 1, s);
  return (int)err;
}

int forward_blocks_per_sm(int* blocks) {
  constexpr size_t smem = Staging<H, float, float>::SMEM;
  blocks[0] = blocks_per_sm((const void*)tile_expand_kernel<true, float>, NT, smem);
  blocks[1] = blocks_per_sm((const void*)tile_conv_kernel<true, float>, NT, smem);
  blocks[2] = blocks_per_sm((const void*)tile_branch_kernel<true, float>, NT, smem);
  blocks[3] = blocks_per_sm((const void*)tile_out_kernel<float>, NT, OutTile<float>::SMEM);
  return (int)cudaGetLastError();
}

// One m16n8k16 bf16 MMA whose accumulator starts at c and receives a single
// product of 0.75 of c's ulp (3 * 2^-13 * 2^-12 against c = +-1): round to
// nearest gives c + ulp, truncation c.
__global__ void bf16_probe_kernel(float* out) {
  const int lane = threadIdx.x;
  const uint32_t a_lo = __bfloat16_as_ushort(__float2bfloat16(3.f * 0x1p-13f));
  const uint32_t b_lo = __bfloat16_as_ushort(__float2bfloat16(0x1p-12f));
  for (int sign = 0; sign < 2; ++sign) {
    // lane 0 holds A (0, 0) and B (0, 0) in the low halves of a0 and b0
    const uint32_t a[4] = {lane == 0 ? (a_lo | (sign ? 0x8000u : 0u)) : 0u, 0u, 0u, 0u};
    const uint32_t b[2] = {lane == 0 ? b_lo : 0u, 0u};
    float c[4] = {sign ? -1.f : 1.f, 0.f, 0.f, 0.f};
    bf16::mma(c, a, b);
    if (lane == 0) out[sign] = c[0];
  }
}

}  // namespace
}  // namespace gated_hifi

// Launches the forward's four stages on `stream`; returns a cudaError_t (0
// on success). kernels/dilations are host arrays of `depth` entries. All
// tensors are contiguous float32 on the device (lens int32): x/out [B, T,
// width], wall [width, depth*2*width], ball [depth*2*width], ks the
// branches' [k_d, H, H] kernels back to back, cb/b1 [depth, H], w1 [depth,
// H, H], wg [width, width], bg [width]; a and h1 are scratch of [B, T,
// depth*H] each. Dropout keeps an element when its 16-bit field is >=
// threshold and scales it by keep_scale; threshold 0 is p = 0.
extern "C" int gated_hifi_fwd(const float* x, const int* lens, const float* wall,
                              const float* ball, const float* ks, const float* cb,
                              const float* w1, const float* b1, const float* wg,
                              const float* bg, float* a, float* h1, float* out, int B, int T,
                              int width, int depth, const int* kernels, const int* dilations,
                              float scale, unsigned seed, unsigned threshold,
                              float keep_scale, void* stream) {
  return gated_hifi::forward(x, lens, wall, ball, ks, cb, w1, b1, wg, bg, a, h1, out, B, T, width, depth, kernels,
                             dilations, scale, seed, threshold, keep_scale, stream);
}

// Resident blocks per SM of the forward's stages, in launch order (expand,
// conv, branch, out), into blocks[0..3]; returns a cudaError_t.
extern "C" int gated_hifi_fwd_blocks_per_sm(int* blocks) { return gated_hifi::forward_blocks_per_sm(blocks); }

// Whether the bf16 MMA's fp32 accumulation rounds to nearest or truncates:
// out[0] = 1 + 0.75 ulp and out[1] = -(1 + 0.75 ulp) as the tensor cores
// sum them (1 + 2^-23 and -(1 + 2^-23) round to nearest; 1 and -1
// truncate). out: 2 floats on the device; returns a cudaError_t.
extern "C" int bf16_mma_probe(float* out, void* stream) {
  gated_hifi::bf16_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return (int)cudaGetLastError();
}
