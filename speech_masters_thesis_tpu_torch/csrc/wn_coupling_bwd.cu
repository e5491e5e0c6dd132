// The Glow-TTS coupling conditioner's recompute backward for Hopper
// (sm_90a), fp32, with the forward's dropout masks regenerated in-kernel.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, function
// _vjp_bwd -> pallas_call(_bwd_kernel) (body _conditioner_bwd), the custom
// VJP of fused_wn_coupling. Plain version:
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
// 0.49 ms at 67 TFLOP/s of fp32, against some 90 MB of scratch traffic.
//
// Design. The TPU kernel holds one sequence in VMEM with per-layer scratch
// (grid (B,)) and accumulates the weight gradients over its sequential grid.
// Here the scratch lives in device memory ([L, B, T, H] layer inputs and
// gate outputs, [L, B, T, 2H] post-dropout conv outputs and their
// cotangents, [L, B, T, H] dh: about 47 MB at (8, 384)), the recompute is
// the forward's launches, and each transposed product is one launch of the
// same row-tiled convolution (conv_rows.cuh) reading its weight transposed
// (and tap-flipped), with the gate derivative, the regenerated mask and the
// residual add in the epilogues. The weight gradients are one fixed-order
// split-over-time reduction (wgrad_rows.cuh), so two calls are bitwise
// equal. One call: 1 + 2 L recompute launches, 1 + 2 L + 1 transposed
// products, 2 reduction launches (21 at 4 layers).

#include <cuda_runtime.h>

#include <vector>

#include "wgrad_rows.cuh"
#include "wn_coupling_common.cuh"

namespace {

struct WnBwdTag {};

struct Grads {
  float* dws;
  float* dbs;
  float* const* dwin;
  float* const* dbin;
  float* const* dwrs;
  float* const* dbrs;
  float* dwend;
  float* dbend;
};

struct Scratch {
  float *hs, *xin, *acts, *skip, *dskip, *dh, *dxin;
};

// Every weight gradient as a reduction problem (pointers may be null when
// only the partials' size is wanted).
std::vector<wgrad_rows::Problem> problems(const float* x0, int ldx, const float* g, const Grads& d,
                                          const Scratch& sc, const wn_coupling::Shape& sh) {
  using wgrad_rows::problem;
  const int H = sh.H, L = sh.n_layers, k = sh.kernel_size;
  const size_t lay = (size_t)sh.B * sh.T * H;
  auto at = [](const float* p, size_t off) { return p ? p + off : nullptr; };
  auto atw = [](float* p, size_t off) { return p ? p + off : nullptr; };
  std::vector<wgrad_rows::Problem> probs;
  wgrad_rows::Problem p = problem(x0, ldx, sh.half, sc.dh, H, H, d.dws, sh.half, 1);
  p.out_b = d.dbs;
  probs.push_back(p);
  int dil = 1;
  for (int i = 0; i < L; ++i, dil *= sh.rate) {
    const int pad = (k - 1) / 2 * dil;
    for (int j = 0; j < k; ++j) {
      p = problem(at(sc.hs, i * lay), H, H, at(sc.dxin, 2 * i * lay), 2 * H, 2 * H,
                  atw(d.dwin ? d.dwin[i] : nullptr, j), H * k, k);
      p.shift = j * dil - pad;
      p.out_b = j == 0 && d.dbin ? d.dbin[i] : nullptr;
      probs.push_back(p);
    }
    float* dwrs = d.dwrs ? d.dwrs[i] : nullptr;
    float* dbrs = d.dbrs ? d.dbrs[i] : nullptr;
    const bool last = i == L - 1;
    if (!last) {  // the residual half of drs: dh_{i+1}
      p = problem(at(sc.acts, i * lay), H, H, at(sc.dh, (i + 1) * lay), H, H, dwrs, H, 1);
      p.out_b = dbrs;
      probs.push_back(p);
    }
    p = problem(at(sc.acts, i * lay), H, H, sc.dskip, H, H, atw(dwrs, last ? 0 : (size_t)H * H), H, 1);
    p.out_b = atw(dbrs, last ? 0 : H);
    probs.push_back(p);
  }
  p = problem(sc.skip, H, H, g, sh.c_out, sh.c_out, d.dwend, H, 1);
  p.mask_x = 1;
  p.out_b = d.dbend;
  probs.push_back(p);
  return probs;
}

}  // namespace

// Floats of the partials buffer wn_coupling_bwd needs.
extern "C" long wn_coupling_bwd_partial_floats(int B, int T, int half, int H, int c_out, int n_layers,
                                               int kernel_size, int dilation_rate, int n_split) {
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh) || n_split < 1) return -1;
  std::vector<wgrad_rows::Problem> probs = problems(nullptr, half, nullptr, Grads{}, Scratch{}, sh);
  return (long)wgrad_rows::assign_partials(probs, n_split);
}

// Launches the backward on `stream`; returns a cudaError_t (0 on success).
// Inputs as for wn_coupling_fwd plus g [B, T, c_out] contiguous; outputs dx0
// [B, T, half] contiguous and the gradients of every weight and bias in
// their own layouts; scratch hs, acts, dh [L, B, T, H], xin, dxin
// [L, B, T, 2H], skip, dskip [B, T, H] and the partials
// (wn_coupling_bwd_partial_floats).
extern "C" int wn_coupling_bwd(const float* x0, int ldx, const int* lens, const long long* seed, const float* g,
                               const float* ws, const float* const* win, const float* const* wrs,
                               const float* wend, const float* bs, const float* const* bin,
                               const float* const* brs, float* dx0, float* dws, float* dbs,
                               float* const* dwin, float* const* dbin, float* const* dwrs,
                               float* const* dbrs, float* dwend, float* dbend, float* hs, float* xin,
                               float* acts, float* skip, float* dskip, float* dh, float* dxin,
                               float* partials, int B, int T, int half, int H, int c_out, int n_layers,
                               int kernel_size, int dilation_rate, unsigned threshold, float keep_scale,
                               int n_split, void* stream) {
  using namespace conv_rows;
  const wn_coupling::Shape sh{B, T, half, H, c_out, n_layers, kernel_size, dilation_rate};
  if (!wn_coupling::valid_shape(sh) || n_split < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lay = (size_t)B * T * H;
  const wn_coupling::Weights w{ws, bs, win, bin, wrs, brs};
  cudaError_t err = wn_coupling::forward_chain<WnBwdTag>(x0, ldx, lens, w, sh, {seed, threshold, keep_scale},
                                                         hs, lay, acts, lay, xin, 2 * lay, skip, s);
  if (err != cudaSuccess) return (int)err;

  Args a{};
  a.lens = lens; a.T = T; a.dil = 1; a.wt = 1; a.hidden = H;
  a.seed = seed; a.threshold = threshold; a.keep_scale = keep_scale;
  a.stream_mul = wn_coupling::WN_STREAMS; a.drop_ld = 2 * H;

  Args e = a;  // dskip = (g W_end^T) * valid
  e.in = g; e.ldi = c_out; e.cin = c_out; e.mask_in = 1;
  e.w = wend; e.n_out = H; e.out = dskip; e.ldo = H;
  err = launch<WnBwdTag, 1, 32, 64, MASK>(e, B, s);
  if (err != cudaSuccess) return (int)err;

  for (int i = n_layers - 1; i >= 0; --i) {
    const bool last = i == n_layers - 1;
    int dil = 1;
    for (int j = 0; j < i; ++j) dil *= dilation_rate;
    float* dh_next = last ? nullptr : dh + (i + 1) * lay;
    Args r = a;  // dacts = drs W_rs^T, then the gate's derivative and the mask
    if (last) {
      r.in = dskip; r.ldi = H; r.cin = H;
    } else {
      r.in = dh_next; r.ldi = H; r.in2 = dskip; r.ldi2 = H; r.split = H; r.cin = 2 * H;
    }
    r.w = wrs[i]; r.n_out = H; r.out = dxin + 2 * i * lay; r.ldo = 2 * H;
    r.xin = xin + 2 * i * lay; r.ldx = 2 * H; r.stream_add = i;
    err = launch<WnBwdTag, 1, 32, 64, GATE_BWD>(r, B, s);
    if (err != cudaSuccess) return (int)err;

    Args c = a;  // dh_i = (dh_{i+1} + conv^T(dx_in, W_in)) * valid
    c.in = dxin + 2 * i * lay; c.ldi = 2 * H; c.cin = 2 * H; c.mask_in = 1;
    c.w = win[i]; c.n_out = H; c.dil = dil; c.out = dh + i * lay; c.ldo = H;
    if (last) {
      err = launch_taps<WnBwdTag, 32, 64, MASK>(kernel_size, c, B, s);
    } else {
      c.res = dh_next; c.ldr = H; c.hidden = 0;
      err = launch_taps<WnBwdTag, 32, 64, RES_SKIP>(kernel_size, c, B, s);
    }
    if (err != cudaSuccess) return (int)err;
  }

  Args x = a;  // dx0 = dh_0 W_s^T
  x.in = dh; x.ldi = H; x.cin = H; x.mask_in = 1;
  x.w = ws; x.n_out = half; x.out = dx0; x.ldo = half;
  err = launch<WnBwdTag, 1, 32, 64, MASK>(x, B, s);
  if (err != cudaSuccess) return (int)err;

  const Grads d{dws, dbs, dwin, dbin, dwrs, dbrs, dwend, dbend};
  std::vector<wgrad_rows::Problem> probs = problems(x0, ldx, g, d, Scratch{hs, xin, acts, skip, dskip, dh, dxin}, sh);
  wgrad_rows::assign_partials(probs, n_split);
  return (int)wgrad_rows::run<WnBwdTag>(probs, lens, B, T, n_split, partials, s);
}
