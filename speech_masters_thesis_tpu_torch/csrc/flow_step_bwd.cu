// One whole Glow-TTS flow step's recompute backward for Hopper (sm_90a),
// fp32, with the forward's dropout masks regenerated in-kernel.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, function
// _flow_vjp_bwd -> pallas_call(_bwd_flow_kernel) (_bwd_flow), the custom VJP
// of fused_flow_step. Plain version:
// ops/flow_step.py:flow_step_backward_reference.
//
// What it computes, for the cotangents g_xc and g_out [B, T, C] of the
// forward's xc and out (flow_step_fwd.cu):
//   recompute x1 = (alb + exp(aln) * x) * valid and xc = x1 mt;
//   the conditioner's backward on xc[:, :half] (wn_coupling_common.cuh)
//     with g_out, giving dx0 and the conditioner's weight gradients;
//   dxc  = [g_xc[:, :half] + dx0, g_xc[:, half:]] * valid
//   dx1  = dxc mt^T
//   dx   = dx1 * exp(aln) * valid
//   dmt  = x1^T dxc,  daln = sum_r dx * x,  dalb = sum_r dx1 * valid
// (the sums over the B * T frames), as the TPU kernel's body does.
//
// What bounds it on an H100: operations, 3x the forward's (the recompute,
// the transposed products, the weight products): about 0.41 ms at (8, 384)
// and 67 TFLOP/s of fp32.
//
// Design: the TPU kernel holds a sequence and its per-layer scratch in VMEM
// and accumulates the weight gradients over its sequential grid. Here the
// recompute's prefix is flow_step_fwd.cu's launch, which also writes x1; the
// conditioner's backward is B3's chain (its last launch adds g_xc's first
// half and masks, so it writes dxc's first half directly); dx1 = dxc mt^T is
// one launch of conv_rows.cuh that reads dxc's second half straight from
// g_xc (a channel split in the loader) and writes dx and dx1 * valid in its
// epilogue (ACTNORM_BWD); and dmt, daln and dalb join the conditioner's
// weight gradients in one fixed-order split-over-time reduction
// (wgrad_rows.cuh: no atomics, two calls bitwise equal). One call: 1 + (3 +
// 4 L) + 1 + 2 launches (23 at 4 layers: 33 reduction problems, one batch).

#include <cuda_runtime.h>

#include <vector>

#include "wgrad_rows.cuh"
#include "wn_coupling_common.cuh"

namespace {

struct FlowBwdTag {};

struct Prefix {
  const float* x;
  const float* x1;
  const float* dxc;   // [B, T, half]: dxc's first half
  const float* g_xc;  // [B, T, C]: dxc's second half is g_xc's, masked
  const float* dx;
  const float* dx1;   // dx1 * valid
  float* daln;
  float* dalb;
  float* dmt;
};

// The conditioner's problems, then the prefix's: dmt's two column halves,
// daln (a diagonal form) and dalb (column sums only).
std::vector<wgrad_rows::Problem> flow_problems(const float* xc, const float* g_out, const wn_coupling::Grads& d,
                                               const wn_coupling::Scratch& sc, const wn_coupling::Shape& sh,
                                               const Prefix& p) {
  using wgrad_rows::problem;
  const int C = sh.c_out, half = sh.half;
  std::vector<wgrad_rows::Problem> probs = wn_coupling::problems(xc, C, g_out, d, sc, sh);
  probs.push_back(problem(p.x1, C, C, p.dxc, half, half, p.dmt, 1, C));
  wgrad_rows::Problem q = problem(p.x1, C, C, p.g_xc ? p.g_xc + half : nullptr, C, half,
                                  p.dmt ? p.dmt + half : nullptr, 1, C);
  q.mask_y = 1;
  probs.push_back(q);
  q = problem(p.x, C, C, p.dx, C, C, p.daln, 1, 0);
  q.diag = q.mask_x = 1;
  probs.push_back(q);
  q = problem(p.x, C, C, p.dx1, C, C, nullptr, 1, 0);
  q.diag = q.mask_x = 1;
  q.out_b = p.dalb;
  probs.push_back(q);
  return probs;
}

}  // namespace

// Floats of the partials buffer flow_step_bwd needs.
extern "C" long flow_step_bwd_partial_floats(int B, int T, int half, int H, int c_out, int n_layers,
                                             int kernel_size, int dilation_rate, int n_split) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh) || c_out != 2 * half || n_split < 1) return -1;
  std::vector<wgrad_rows::Problem> probs =
      flow_problems(nullptr, nullptr, wn_coupling::Grads{}, wn_coupling::Scratch{}, sh, Prefix{});
  return (long)wgrad_rows::assign_partials(probs, n_split);
}

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// Inputs as for flow_step_fwd plus g_xc, g_out [B, T, c_out] contiguous;
// outputs dx [B, T, c_out], daln, dalb [c_out], dmt [c_out, c_out] and the
// conditioner's weight gradients in their own layouts; scratch x1, xc, dx1
// [B, T, c_out], dxc [B, T, half], the conditioner's (as wn_coupling_bwd) and
// the partials (flow_step_bwd_partial_floats).
extern "C" int flow_step_bwd(const float* x, const int* lens, const long long* seed, const float* g_xc,
                             const float* g_out, const float* aln, const float* alb, const float* mt,
                             const float* ws, const float* const* win, const float* const* wrs, const float* wend,
                             const float* bs, const float* const* bin, const float* const* brs, float* dx,
                             float* daln, float* dalb, float* dmt, float* dws, float* dbs, float* const* dwin,
                             float* const* dbin, float* const* dwrs, float* const* dbrs, float* dwend,
                             float* dbend, float* x1, float* xc, float* dxc, float* dx1, float* hs, float* xin,
                             float* acts, float* skip, float* dskip, float* dh, float* dxin, float* partials, int B,
                             int T, int half, int H, int c_out, int n_layers, int kernel_size, int dilation_rate,
                             unsigned threshold, float keep_scale, int n_split, void* stream) {
  using namespace conv_rows;
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh) || c_out != 2 * half || n_split < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = c_out;
  cudaError_t err = wn_coupling::flow_prefix<FlowBwdTag>(x, lens, aln, alb, mt, B, T, C, xc, x1, s);
  if (err != cudaSuccess) return (int)err;

  const wn_coupling::Weights w{ws, bs, win, bin, wrs, brs, wend, nullptr};
  const wn_coupling::Scratch sc{hs, xin, acts, skip, dskip, dh, dxin};
  err = wn_coupling::backward_chain<FlowBwdTag>(xc, C, lens, g_out, w, sh, {seed, threshold, keep_scale}, sc, g_xc,
                                                C, dxc, half, s);
  if (err != cudaSuccess) return (int)err;

  Args a{};  // dx1 = dxc mt^T; dx = dx1 * exp(aln) * valid and dx1 * valid
  a.lens = lens; a.T = T; a.dil = 1;
  a.in = dxc; a.ldi = half; a.in2 = g_xc + half; a.ldi2 = C; a.split = half; a.cin = C; a.mask_in = 1;
  a.w = mt; a.n_out = C; a.out = dx; a.out2 = dx1; a.ldo = C; a.out_logs = aln;
  err = launch<FlowBwdTag, 1, 32, 64, ACTNORM_BWD>(a, B, s);
  if (err != cudaSuccess) return (int)err;

  const wn_coupling::Grads d{dws, dbs, dwin, dbin, dwrs, dbrs, dwend, dbend};
  std::vector<wgrad_rows::Problem> probs =
      flow_problems(xc, g_out, d, sc, sh, Prefix{x, x1, dxc, g_xc, dx, dx1, daln, dalb, dmt});
  wgrad_rows::assign_partials(probs, n_split);
  return (int)wgrad_rows::run<FlowBwdTag>(probs, lens, B, T, n_split, partials, s);
}
