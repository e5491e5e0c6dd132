// One whole Glow-TTS flow step (ActNorm -> InvConvNear -> the coupling
// conditioner) forward for Hopper (sm_90a), fp32, with dropout.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, function
// fused_flow_step -> pallas_call(_fwd_flow_kernel) (_fwd_flow), in its fp32
// mode (the bf16 mode, dot_dtype = x's dtype, is wn_coupling_bf16.cu). The
// recompute backward (its _flow_vjp_bwd) is flow_step_bwd.cu. Plain version:
// ops/flow_step.py:flow_step_reference.
//
// What it computes for x [B, T, C] (C = 2 * half), the ActNorm's aln, alb [C]
// and the InvConvNear's dense transposed matrix mt [C, C]:
//   x1  = (alb + exp(aln) * x) * valid                       ActNorm
//   xc  = x1 mt                                              InvConvNear
//   out = the coupling conditioner on xc[:, :half]           (wn_coupling_fwd.cu)
// and returns xc and out, as the TPU kernel does; the logdets stay outside.
//
// What bounds it on an H100: operations, the conditioner's (about 0.136 ms
// at (8, 384) at 67 TFLOP/s of fp32 on the CUDA cores) plus 2 C^2 a frame
// for the [C, C] product (157 MFLOP at (8, 384), 2.3 us): about 0.139 ms,
// or 0.057 ms at 3x the operations over 495 TFLOP/s of TF32 in 3xTF32.
//
// Design: the TPU kernel keeps the whole sequence in VMEM and runs the
// prefix as a few vector ops and one matrix product ahead of the
// conditioner. Here the prefix is one launch of the tensor-core
// convolution (conv_mma.cuh, 3xTF32) as a 1x1 conv whose weight is mt read
// transposed, with the ActNorm and the length mask applied to each staged
// slice in shared memory; xc goes to device memory once (the affine
// coupling reads it), and the conditioner's chain (wn_coupling_common.cuh,
// on the same engine) reads its first half through a row stride of C. The
// backward's recompute (flow_step_bwd.cu) runs the same launches. One call:
// 1 + 1 + 2 + 2 * n_layers launches (12 at 4 layers: the prefix, the
// packing, the conditioner's).

#include <cuda_runtime.h>

#include "wn_coupling_common.cuh"

namespace {
struct FlowFwdTag {};
}  // namespace

// Floats of the workspace flow_step_fwd needs: the conditioner's packed
// dilated-conv weights (-1 for a shape the kernels do not take).
extern "C" long flow_step_fwd_workspace_floats(int B, int T, int half, int H, int c_out, int n_layers,
                                               int kernel_size, int dilation_rate) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh) || c_out != 2 * half) return -1;
  return (long)wn_coupling::packed_floats(sh, 1);
}

// Launches the forward on `stream`; returns a cudaError_t (0 on success).
// x [B, T, c_out] contiguous, c_out = 2 * half; the conditioner's weights as
// for wn_coupling_fwd; outputs xc [B, T, c_out] and out [B, T, c_out]
// contiguous; scratch h, acts, skip [B, T, H] and the workspace
// (flow_step_fwd_workspace_floats).
extern "C" int flow_step_fwd(const float* x, const int* lens, const long long* seed, const float* aln,
                             const float* alb, const float* mt, const float* ws, const float* bs,
                             const float* const* win, const float* const* bin, const float* const* wrs,
                             const float* const* brs, const float* wend, const float* bend, float* xc,
                             float* out, float* h, float* acts, float* skip, float* workspace, int B, int T,
                             int half, int H, int c_out, int n_layers, int kernel_size, int dilation_rate,
                             unsigned threshold, float keep_scale, void* stream) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh) || c_out != 2 * half) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = wn_coupling::flow_prefix<FlowFwdTag>(x, lens, aln, alb, mt, B, T, c_out, xc, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  const wn_coupling::Weights w{ws, bs, win, bin, wrs, brs, wend, bend};
  return (int)wn_coupling::forward<FlowFwdTag>(xc, c_out, lens, w, sh, {seed, threshold, keep_scale}, out, h,
                                               acts, skip, workspace, s);
}
