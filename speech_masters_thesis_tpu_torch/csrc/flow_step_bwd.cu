// One whole Glow-TTS flow step's recompute backward for Hopper (sm_90a),
// fp32, with the forward's dropout masks regenerated in-kernel.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, function
// _flow_vjp_bwd -> pallas_call(_bwd_flow_kernel) (_bwd_flow), the custom VJP
// of fused_flow_step, in its fp32 mode (the bf16 mode is
// wn_coupling_bf16.cu). Plain version:
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
// and 67 TFLOP/s of fp32 on the CUDA cores, 0.17 ms in 3xTF32 at 495
// TFLOP/s of TF32.
//
// Design: the TPU kernel holds a sequence and its per-layer scratch in VMEM
// and accumulates the weight gradients over its sequential grid. Here every
// product runs on the tensor cores in 3xTF32 (tf32_mma.cuh), fp32 at the
// interfaces. The recompute's prefix is flow_step_fwd.cu's launch on the
// tensor-core engine (conv_mma.cuh, the ActNorm applied to each staged
// slice), which also writes x1; the conditioner's backward is B3's chain
// (its last launch adds g_xc's first half and masks, so it writes dxc's
// first half directly); dx1 = dxc mt^T is one launch of the same engine
// that reads dxc's second half straight from g_xc (a channel split in the
// loader) and writes dx and dx1 * valid in its epilogue (ACTNORM_BWD); dmt
// joins the conditioner's weight gradients in one fixed-order
// split-over-frames reduction with the frames as the MMAs' k
// (wgrad_mma.cuh), and daln (a diagonal sum) and dalb (column sums) take
// wgrad_rows.cuh's on the CUDA cores: no atomics, two calls bitwise equal.
// One call: 1 + (4 + 4 L, a packing launch with B3's chain) + 1 + 2 + 2
// launches (26 at 4 layers: 31 products, then 2 CUDA-core problems).

#include <cuda_runtime.h>

#include <vector>

#include "wgrad_mma.cuh"
#include "wgrad_rows.cuh"
#include "wn_coupling_common.cuh"

namespace {

struct FlowBwdTag {};

struct Prefix {
  const float* x;
  const float* x1;
  const float* dxc;   // [B, T, half]: dxc's first half
  const float* g_xc;  // [B, T, C]: dxc's second half is g_xc's, masked
  const float* dx;    // dx1 * exp(aln) * valid
  const float* dx1;   // dx1 * valid
  float* daln;
  float* dalb;
  float* dmt;
};

// The conditioner's problems, then the prefix's: dmt's two column halves
// (the tensor cores' products), and the CUDA cores' daln (a diagonal form)
// and dalb (column sums only), each list laid out and its slices chosen.
struct FlowProblems {
  std::vector<wgrad_rows::Problem> mma, rows;
  int mma_split, rows_split;
  long long mma_floats, rows_floats;
};

FlowProblems flow_problems(const float* xc, const float* g_out, const wn_coupling::Grads& d,
                           const wn_coupling::Scratch& sc, const wn_coupling::Shape& sh, const Prefix& p) {
  using wgrad_rows::problem;
  const int C = sh.c_out, half = sh.half;
  const long long frames = (long long)sh.B * sh.T;
  const float* g_xc2 = p.g_xc ? p.g_xc + half : nullptr;
  FlowProblems f;
  f.mma = wn_coupling::problems(xc, C, g_out, d, sc, sh);
  wgrad_rows::Problem q = problem(p.x1, C, C, p.dxc, half, half, p.dmt, 1, C);
  f.mma.push_back(q);
  q = problem(p.x1, C, C, g_xc2, C, half, p.dmt ? p.dmt + half : nullptr, 1, C);
  q.mask_y = 1;
  f.mma.push_back(q);
  const long long tiles = wgrad_mma::assign_tiles(f.mma);
  f.mma_split = wgrad_mma::splits<FlowBwdTag>(tiles, frames);
  f.mma_floats = tiles * f.mma_split * wgrad_mma::PART;
  q = problem(p.x, C, C, p.dx, C, C, p.daln, 1, 0);
  q.diag = q.mask_x = 1;
  f.rows.push_back(q);
  q = problem(p.x, C, C, p.dx1, C, C, nullptr, 1, 0);
  q.diag = q.mask_x = 1;
  q.out_b = p.dalb;
  f.rows.push_back(q);
  // two light problems of 3 tiles each: slices of 64 frames (at most 64) spread them over the card
  f.rows_split = (int)((frames + 63) / 64 < 64 ? (frames + 63) / 64 : 64);
  f.rows_floats = wgrad_rows::assign_partials(f.rows, f.rows_split);
  return f;
}

// The whole backward.
cudaError_t backward(const float* x, const int* lens, const long long* seed, const float* g_xc, const float* g_out,
                     const float* aln, const float* alb, const float* mt, const wn_coupling::Weights& w,
                     const wn_coupling::Grads& d, float* dx, float* daln, float* dalb, float* dmt, float* x1,
                     float* xc, float* dxc, float* dx1, const wn_coupling::Scratch& sc, float* workspace,
                     const wn_coupling::Shape& sh, const wn_coupling::Dropout& drop, cudaStream_t s) {
  using namespace conv_rows;
  using Tag = FlowBwdTag;
  const int B = sh.B, T = sh.T, C = sh.c_out, half = sh.half;
  cudaError_t err = wn_coupling::flow_prefix<Tag>(x, lens, aln, alb, mt, B, T, C, xc, x1, s);
  if (err != cudaSuccess) return err;
  err = wn_coupling::backward_chain<Tag>(xc, C, lens, g_out, w, sh, drop, sc, g_xc, C, dxc, half, workspace, s);
  if (err != cudaSuccess) return err;

  Args a{};  // dx1 = dxc mt^T; dx = dx1 * exp(aln) * valid and dx1 * valid
  a.lens = lens; a.T = T; a.dil = 1;
  a.in = dxc; a.ldi = half; a.ldi2 = C; a.split = half; a.cin = C; a.mask_in = 1;
  a.in2 = g_xc + half;
  a.w = mt; a.n_out = C; a.out = dx; a.out2 = dx1; a.ldo = C; a.out_logs = aln;
  err = wn_coupling::launch<Tag, 1, ACTNORM_BWD>(a, B, s);
  if (err != cudaSuccess) return err;

  const FlowProblems f = flow_problems(xc, g_out, d, sc, sh, Prefix{x, x1, dxc, g_xc, dx, dx1, daln, dalb, dmt});
  if (f.mma_split < 1) return cudaErrorInvalidValue;
  float* partials = workspace + wn_coupling::packed_floats(sh, 2);
  err = wgrad_mma::run<Tag>(f.mma, lens, B, T, f.mma_split, partials, s);
  if (err != cudaSuccess) return err;
  return wgrad_rows::run<Tag>(f.rows, lens, B, T, f.rows_split, partials + f.mma_floats, s);
}

}  // namespace

// Floats of the workspace flow_step_bwd needs: the
// packed weights, then the two reductions' partials (-1 for a shape the
// kernels do not take).
extern "C" long flow_step_bwd_workspace_floats(int B, int T, int half, int H, int c_out, int n_layers,
                                               int kernel_size, int dilation_rate) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh) || c_out != 2 * half) return -1;
  const FlowProblems f = flow_problems(nullptr, nullptr, wn_coupling::Grads{}, wn_coupling::Scratch{}, sh, Prefix{});
  if (f.mma_split < 1) return -1;
  return (long)(wn_coupling::packed_floats(sh, 2) + f.mma_floats + f.rows_floats);
}

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// Inputs as for flow_step_fwd plus g_xc, g_out [B, T, c_out] contiguous;
// outputs dx [B, T, c_out], daln, dalb [c_out], dmt [c_out, c_out] and the
// conditioner's weight gradients in their own layouts; scratch x1, xc, dx1
// [B, T, c_out], dxc [B, T, half], the conditioner's (as wn_coupling_bwd) and
// the workspace (flow_step_bwd_workspace_floats).
extern "C" int flow_step_bwd(const float* x, const int* lens, const long long* seed, const float* g_xc,
                             const float* g_out, const float* aln, const float* alb, const float* mt,
                             const float* ws, const float* const* win, const float* const* wrs, const float* wend,
                             const float* bs, const float* const* bin, const float* const* brs, float* dx,
                             float* daln, float* dalb, float* dmt, float* dws, float* dbs, float* const* dwin,
                             float* const* dbin, float* const* dwrs, float* const* dbrs, float* dwend,
                             float* dbend, float* x1, float* xc, float* dxc, float* dx1, float* hs, float* xin,
                             float* acts, float* skip, float* dskip, float* dh, float* dxin, float* workspace, int B,
                             int T, int half, int H, int c_out, int n_layers, int kernel_size, int dilation_rate,
                             unsigned threshold, float keep_scale, void* stream) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh) || c_out != 2 * half) return (int)cudaErrorInvalidValue;
  const wn_coupling::Weights w{ws, bs, win, bin, wrs, brs, wend, nullptr};
  const wn_coupling::Grads d{dws, dbs, dwin, dbin, dwrs, dbrs, dwend, dbend};
  const wn_coupling::Scratch sc{hs, xin, acts, skip, dskip, dh, dxin};
  return (int)backward(x, lens, seed, g_xc, g_out, aln, alb, mt, w, d, dx, daln, dalb, dmt, x1, xc, dxc, dx1, sc,
                       workspace, sh, {seed, threshold, keep_scale}, static_cast<cudaStream_t>(stream));
}
