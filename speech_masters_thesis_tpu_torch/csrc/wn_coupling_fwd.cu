// The Glow-TTS coupling conditioner (WaveNet with weight norm) forward for
// Hopper (sm_90a), fp32, with dropout.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, function
// fused_wn_coupling -> pallas_call(_fwd_kernel) (body _forward_body), in its
// fp32 mode (the bf16 mode, dot_dtype = x0's dtype, is wn_coupling_bf16.cu).
// The recompute backward (its _vjp_bwd) is wn_coupling_bwd.cu. Plain
// version: ops/wn_coupling.py:wn_coupling_reference.
//
// What it computes for x0 [B, T, half] (rows ldx floats apart: the first
// half of the coupling input) and the post-weight-norm weights:
//   h    = (x0 W_s + b_s) * valid                                start 1x1
//   for each layer i (dilation rate^i):
//     z    = (conv_k(h, W_in_i, dil) + b_in_i) * keep_i          [T, 2H]
//     acts = tanh(z[:, :H]) * sigmoid(z[:, H:])
//     rs   = acts W_rs_i + b_rs_i
//     h    = (h + rs[:, :H]) * valid, skip += rs[:, H:]          (i < L - 1)
//     skip += rs                                                 (last layer)
//   out  = (skip * valid) W_end + b_end                          [T, c_out]
// with valid = t < lens[b]: the start output, each residual and the skip
// sum are masked where the JAX kernel masks them (wn_coupling.py:137-160,
// :178). keep_i is 1 without dropout (threshold 0), else the hash mask of
// wn_coupling_common.cuh, scaled by 1/(1-p).
//
// What bounds it on an H100: operations. At Glow-TTS's width (half 80,
// H 192, k 5, 4 layers, c_out 160) a squeezed frame costs about 3.56 MFLOP
// and moves 960 bytes of input and output, so at (8, 384) it is 10.9 GFLOP
// against 2.9 MB: about 0.16 ms at 67 TFLOP/s of fp32 on the CUDA cores,
// 0.066 ms at 3 x 10.9 GFLOP over 495 TFLOP/s of TF32 in 3xTF32.
//
// Design: the TPU holds a whole sequence in VMEM with grid (B,), which gives
// 8 programs. Here each step of the chain is one launch of the tensor-core
// convolution (conv_mma.cuh: 3xTF32 MMAs, fp32 at the interfaces, each
// k-step's products added to the accumulators in fp32) over (row tile,
// channel tile, sequence), so the time axis spreads over the card. Each
// conv tap is a shifted k-slice of the same rows, so no tile holds a halo.
// The dilated conv's launch computes the channel pairs (c, H + c) in one
// tile and applies the dropout and the gate in its epilogue; the res/skip
// launch updates h in place and accumulates the skip sum; the end 1x1 adds
// its bias. The dilated convs' weights ([2H, H, k] a layer, 1.47 MB) are
// packed tap-major once a call into the workspace
// (wn_coupling_fwd_workspace_floats), which the loaders stage 32 input
// channels at a time. One conditioner call is a packing launch (k > 1) and
// 2 + 2 * n_layers convolutions (11 at 4 layers); h, acts and skip ([B, T,
// H] each) go through device memory between them. The backward's recompute
// (wn_coupling_bwd.cu) runs the same chain.

#include <cuda_runtime.h>

#include "wn_coupling_common.cuh"

namespace {
struct WnFwdTag {};
}  // namespace

// Floats of the workspace wn_coupling_fwd needs: the packed dilated-conv
// weights (-1 for a shape the kernels do not take).
extern "C" long wn_coupling_fwd_workspace_floats(int B, int T, int half, int H, int c_out, int n_layers,
                                                 int kernel_size, int dilation_rate) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh)) return -1;
  return (long)wn_coupling::packed_floats(sh, 1);
}

// Launches the forward on `stream`; returns a cudaError_t (0 on success).
// x0 [B, T, half] rows ldx floats apart; the weights in PyTorch's Conv1d
// layout; out [B, T, c_out] contiguous; scratch h, acts, skip [B, T, H] and
// the workspace (wn_coupling_fwd_workspace_floats).
extern "C" int wn_coupling_fwd(const float* x0, int ldx, const int* lens, const long long* seed,
                               const float* ws, const float* bs, const float* const* win,
                               const float* const* bin, const float* const* wrs,
                               const float* const* brs, const float* wend, const float* bend,
                               float* out, float* h, float* acts, float* skip, float* workspace, int B, int T,
                               int half, int H, int c_out, int n_layers, int kernel_size, int dilation_rate,
                               unsigned threshold, float keep_scale, void* stream) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh)) return (int)cudaErrorInvalidValue;
  const wn_coupling::Weights w{ws, bs, win, bin, wrs, brs, wend, bend};
  return (int)wn_coupling::forward<WnFwdTag>(x0, ldx, lens, w, sh, {seed, threshold, keep_scale}, out, h, acts,
                                             skip, workspace, static_cast<cudaStream_t>(stream));
}
