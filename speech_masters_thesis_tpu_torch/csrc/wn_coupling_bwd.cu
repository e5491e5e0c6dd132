// The Glow-TTS coupling conditioner's recompute backward for Hopper
// (sm_90a), fp32, with the forward's dropout masks regenerated in-kernel.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, function
// _vjp_bwd -> pallas_call(_bwd_kernel) (body _conditioner_bwd), the custom
// VJP of fused_wn_coupling, in its fp32 mode (the bf16 mode is
// wn_coupling_bf16.cu). Plain version:
// ops/wn_coupling.py:wn_coupling_backward_reference.
//
// What it computes, for the output cotangent g [B, T, c_out]:
//   recompute (wn_coupling_common.cuh): each layer's input h_i, its
//     post-dropout conv output x_in_i and gate output acts_i, the skip sum;
//   dskip = (g W_end^T) * valid
//   per layer i in reverse, drs = [dh_{i+1}, dskip] (dskip alone for the last):
//     dacts  = drs W_rs_i^T
//     dx_in  = [dacts * s * (1 - t^2), dacts * t * s * (1 - s)] * keep_i,
//              t = tanh(x_in[:, :H]), s = sigmoid(x_in[:, H:])
//     dh_i   = (dh_{i+1} + conv_k^T(dx_in, W_in_i)) * valid
//   dx0 = dh_0 W_s^T
//   and every weight's gradient, X^T dY over the B * T frames: W_end from
//   (skip * valid, g), W_rs_i from (acts_i, drs), W_in_i from (h_i shifted by
//   each tap, dx_in_i), W_s from (x0, dh_0); the biases are dY's column sums.
//
// What bounds it on an H100: operations, 3x the forward's (recompute, the
// transposed products, the weight products): about 32.7 GFLOP at (8, 384),
// 0.49 ms at 67 TFLOP/s of fp32 on the CUDA cores, 0.20 ms at 3 x 32.7
// GFLOP over 495 TFLOP/s of TF32 in 3xTF32, against some 90 MB of scratch
// traffic; in bf16 0.033 ms at 989 TFLOP/s.
//
// Design. The TPU kernel holds one sequence in VMEM with per-layer scratch
// (grid (B,)) and accumulates the weight gradients over its sequential grid.
// Here the scratch lives in device memory ([L, B, T, H] layer inputs and
// gate outputs, [L, B, T, 2H] post-dropout conv outputs and their
// cotangents, [L, B, T, H] dh: about 47 MB at (8, 384)), and every product
// runs on the tensor cores in 3xTF32 (tf32_mma.cuh), fp32 at the
// interfaces. The recompute is the forward's chain on the tensor-core
// engine (conv_mma.cuh, each conv tap a shifted k-slice), and each
// transposed product is one launch of the same engine reading its weight
// transposed (the dilated conv's tap-flipped, from a packed copy), with the
// gate derivative, the regenerated mask and the residual add in
// conv_rows.cuh's epilogues. The weight gradients are one fixed-order
// split-over-frames reduction with the frames as the MMAs' k
// (wgrad_mma.cuh), so two calls are bitwise equal. One call: a packing
// launch (k > 1), 1 + 2 L recompute launches, 1 + 2 L + 1 transposed
// products, 2 reduction launches (22 at 4 layers).

#include <cuda_runtime.h>

#include <vector>

#include "wgrad_mma.cuh"
#include "wn_coupling_common.cuh"

namespace {

struct WnBwdTag {};

// The weight-gradient problems with their tiles assigned, and the slices.
std::vector<wgrad_rows::Problem> wgrad_problems(const float* x0, int ldx, const float* g,
                                                const wn_coupling::Grads& d, const wn_coupling::Scratch& sc,
                                                const wn_coupling::Shape& sh, int* n_split, long long* tiles) {
  std::vector<wgrad_rows::Problem> probs = wn_coupling::problems(x0, ldx, g, d, sc, sh);
  *tiles = wgrad_mma::assign_tiles(probs);
  *n_split = wgrad_mma::splits<WnBwdTag>(*tiles, (long long)sh.B * sh.T);
  return probs;
}

}  // namespace

// Floats of the workspace wn_coupling_bwd needs: the packed weights, then
// the reduction's partials (-1 for a shape the kernels do not take).
extern "C" long wn_coupling_bwd_workspace_floats(int B, int T, int half, int H, int c_out, int n_layers,
                                                 int kernel_size, int dilation_rate) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh)) return -1;
  int n_split;
  long long tiles;
  wgrad_problems(nullptr, half, nullptr, wn_coupling::Grads{}, wn_coupling::Scratch{}, sh, &n_split, &tiles);
  if (n_split < 1) return -1;
  return (long)(wn_coupling::packed_floats(sh, 2) + (size_t)tiles * n_split * wgrad_mma::PART);
}

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// Inputs as for wn_coupling_fwd plus g [B, T, c_out] contiguous; outputs dx0
// [B, T, half] contiguous and the gradients of every weight and bias in
// their own layouts; scratch hs, acts, dh [L, B, T, H], xin, dxin
// [L, B, T, 2H], skip, dskip [B, T, H] and the workspace
// (wn_coupling_bwd_workspace_floats).
extern "C" int wn_coupling_bwd(const float* x0, int ldx, const int* lens, const long long* seed, const float* g,
                               const float* ws, const float* const* win, const float* const* wrs,
                               const float* wend, const float* bs, const float* const* bin,
                               const float* const* brs, float* dx0, float* dws, float* dbs,
                               float* const* dwin, float* const* dbin, float* const* dwrs,
                               float* const* dbrs, float* dwend, float* dbend, float* hs, float* xin,
                               float* acts, float* skip, float* dskip, float* dh, float* dxin,
                               float* workspace, int B, int T, int half, int H, int c_out, int n_layers,
                               int kernel_size, int dilation_rate, unsigned threshold, float keep_scale,
                               void* stream) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const wn_coupling::Weights w{ws, bs, win, bin, wrs, brs, wend, nullptr};
  const wn_coupling::Scratch sc{hs, xin, acts, skip, dskip, dh, dxin};
  cudaError_t err = wn_coupling::backward_chain<WnBwdTag>(x0, ldx, lens, g, w, sh, {seed, threshold, keep_scale},
                                                          sc, nullptr, 0, dx0, half, workspace, s);
  if (err != cudaSuccess) return (int)err;
  const wn_coupling::Grads d{dws, dbs, dwin, dbin, dwrs, dbrs, dwend, dbend};
  int n_split;
  long long tiles;
  std::vector<wgrad_rows::Problem> probs = wgrad_problems(x0, ldx, g, d, sc, sh, &n_split, &tiles);
  if (n_split < 1) return (int)cudaErrorInvalidValue;
  return (int)wgrad_mma::run<WnBwdTag>(probs, lens, B, T, n_split, workspace + wn_coupling::packed_floats(sh, 2), s);
}

// The tensor-core kernels' resident blocks per SM and dynamic shared memory
// bytes at their launches: the gate conv (128 columns), the transposed conv
// (64), the weight-gradient slices. Returns a cudaError_t.
extern "C" int wn_coupling_bwd_blocks_per_sm(int* blocks, long long* smem) {
  using namespace conv_rows;
  const void* kernels[3] = {(const void*)conv_mma::conv_mma_kernel<WnBwdTag, 5, 128, GATE, true>,
                            (const void*)conv_mma::conv_mma_kernel<WnBwdTag, 5, 64, RES_SKIP, true>,
                            (const void*)wgrad_mma::wgrad_mma_kernel<WnBwdTag, true>};
  const size_t bytes[3] = {conv_mma::Tile<128>::SMEM, conv_mma::Tile<64>::SMEM, wgrad_mma::SMEM};
  for (int i = 0; i < 3; ++i) {
    blocks[i] = conv_mma::blocks_per_sm(kernels[i], bytes[i]);
    smem[i] = (long long)bytes[i];
  }
  return (int)cudaGetLastError();
}
