// The Glow-TTS coupling conditioner's launch chains, shared by its kernels
// (wn_coupling_{fwd,bwd}.cu) and the whole flow step's (flow_step_{fwd,bwd}.cu):
// the forward (start 1x1, then per layer the dilated conv with dropout and the
// gate and the res/skip 1x1, then the end 1x1), the backward's recompute and
// transposed products, its weight-gradient problems, and the flow step's
// prefix (ActNorm + InvConvNear as one [C, C] product). Each step is a launch
// of the tensor-core convolution (conv_mma.cuh, 3xTF32) with conv_rows.cuh's
// epilogues; each kernel file's Tag gives its launches kernels of their own.
//
// Dropout of layer i's conv output (both halves, before the gate): stream
// b * WN_STREAMS + i, counter t * 2H + c (ops/wn_coupling.py:keep_mask).
//
// fp32 only: the bf16 forwards and backwards are wn_coupling_bf16.cu's own
// engine.

#pragma once

#include <cuda_runtime.h>

#include <vector>

#include "conv_mma.cuh"
#include "conv_rows.cuh"
#include "wgrad_mma.cuh"
#include "wgrad_rows.cuh"

namespace wn_coupling {

constexpr int WN_STREAMS = 64;  // ops/wn_coupling.py WN_STREAMS: at most this many layers
static_assert(conv_mma::MAX_PACK >= WN_STREAMS, "one packing launch takes every layer's weights");

// One step of a chain: conv_mma's launch, 128 columns (64 channel pairs)
// for GATE and 64 otherwise. The weight of a TAPS > 1 launch is
// conv_mma::pack's copy (conv_mma::weight_of).
template <class Tag, int TAPS, int EPI>
cudaError_t launch(const conv_rows::Args& a, int B, cudaStream_t s) {
  return conv_mma::launch<Tag, TAPS, EPI == conv_rows::GATE ? 128 : 64, EPI, 64, 4>(a, B, s);
}

// The same with the number of taps chosen at run time (1, 3 or 5).
template <class Tag, int EPI>
cudaError_t launch_taps(int taps, const conv_rows::Args& a, int B, cudaStream_t s) {
  switch (taps) {
    case 1: return launch<Tag, 1, EPI>(a, B, s);
    case 3: return launch<Tag, 3, EPI>(a, B, s);
    case 5: return launch<Tag, 5, EPI>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

struct Weights {
  const float* ws;
  const float* bs;
  const float* const* win;
  const float* const* bin;
  const float* const* wrs;
  const float* const* brs;
  const float* wend;
  const float* bend;
};

struct Shape {
  int B, T, half, H, c_out, n_layers, kernel_size, rate;
};

struct Dropout {
  const long long* seed;
  unsigned threshold;
  float keep_scale;
};

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

// The backward's buffers in device memory: hs, acts, dh [L, B, T, H], xin,
// dxin [L, B, T, 2H], skip, dskip [B, T, H].
struct Scratch {
  float *hs, *xin, *acts, *skip, *dskip, *dh, *dxin;
};

inline bool valid_shape(const Shape& s) {
  return s.B >= 1 && s.B <= 65535 && s.T >= 1 && s.n_layers >= 1 && s.n_layers <= WN_STREAMS &&
         s.H >= 1 && s.half >= 1 && s.c_out >= 1 &&
         (s.kernel_size == 1 || s.kernel_size == 3 || s.kernel_size == 5);
}

// Floats of the packed dilated-conv weights, `forms` of every layer's (the
// conv's for the forward, both for the backward; none for k = 1).
inline size_t packed_floats(const Shape& s, int forms) {
  return s.kernel_size > 1 ? (size_t)forms * s.n_layers * s.kernel_size * 2 * s.H * s.H : 0;
}

// Layer i reads hs + i * hs_step and (i < n_layers - 1) writes hs + (i + 1) *
// hs_step (hs_step 0: h updated in place); its gate output goes to acts + i *
// acts_step and, when xin is set, its post-dropout conv output to xin + i *
// xin_step ([B, T, 2H]). The skip sum goes to skip. For k > 1, w.win holds
// the packed copies (pack_win).
template <class Tag>
cudaError_t forward_chain(const float* x0, int ldx, const int* lens, const Weights& w, const Shape& sh,
                          const Dropout& drop, float* hs, size_t hs_step, float* acts, size_t acts_step,
                          float* xin, size_t xin_step, float* skip, cudaStream_t s) {
  using namespace conv_rows;
  const int H = sh.H;
  Args a{};
  a.lens = lens;
  a.T = sh.T;
  a.hidden = H;
  a.dil = 1;

  a.in = x0; a.ldi = ldx; a.cin = sh.half; a.mask_in = 0;
  a.w = w.ws; a.bias = w.bs; a.n_out = H; a.out = hs; a.ldo = H;
  cudaError_t err = launch<Tag, 1, MASK>(a, sh.B, s);
  if (err != cudaSuccess) return err;

  int dil = 1;
  for (int i = 0; i < sh.n_layers; ++i, dil *= sh.rate) {
    float* h = hs + i * hs_step;
    float* act = acts + i * acts_step;
    Args g = a;
    g.in = h; g.ldi = H; g.cin = H; g.mask_in = 1;
    g.w = w.win[i]; g.bias = w.bin[i]; g.n_out = 2 * H; g.dil = dil; g.out = act; g.ldo = H;
    g.xin = xin ? xin + i * xin_step : nullptr; g.ldx = 2 * H;
    g.seed = drop.seed; g.threshold = drop.threshold; g.keep_scale = drop.keep_scale;
    g.stream_mul = WN_STREAMS; g.stream_add = i; g.drop_ld = 2 * H;
    err = launch_taps<Tag, GATE>(sh.kernel_size, g, sh.B, s);
    if (err != cudaSuccess) return err;

    // h in place (hs_step 0) is safe: this launch reads act, and its
    // epilogue reads each residual element of h in the statement that
    // writes it, in the one thread that owns that element
    Args r = a;
    r.in = act; r.ldi = H; r.cin = H; r.mask_in = 0;
    r.w = w.wrs[i]; r.bias = w.brs[i]; r.n_out = i < sh.n_layers - 1 ? 2 * H : H;
    r.out = i < sh.n_layers - 1 ? hs + (i + 1) * hs_step : h; r.ldo = H; r.res = h; r.ldr = H;
    r.skip = skip; r.lds = H; r.first = i == 0;
    err = launch<Tag, 1, RES_SKIP>(r, sh.B, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Each layer's W_in as the conv ([k][H][2H], form 0 of conv_mma::pack)
// into `packed` (packed_floats(sh, forms)), in the list `win`; a 1x1
// conv's weight is read as it is. With forms 2 the transposes
// ([k][2H][H], tap-flipped) follow each layer's conv, listed in `win_t`.
template <class Tag, int FORMS>
cudaError_t pack_win(const Weights& w, const Shape& sh, float* packed, std::vector<const float*>& win,
                     std::vector<const float*>* win_t, cudaStream_t s) {
  const int H = sh.H, L = sh.n_layers, k = sh.kernel_size;
  win.assign(w.win, w.win + L);
  if (win_t) win_t->assign(w.win, w.win + L);
  if (k == 1) return cudaSuccess;
  const cudaError_t err = conv_mma::pack<Tag, FORMS>(w.win, L, packed, 2 * H, H, k, s);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < L; ++i) {
    float* conv = packed + (size_t)FORMS * i * k * 2 * H * H;
    win[i] = conv;
    if (win_t) (*win_t)[i] = conv + (size_t)k * 2 * H * H;
  }
  return cudaSuccess;
}

// The whole conditioner: the dilated convs' weights packed into `packed`
// (packed_floats(sh, 1)), the chain with h updated in place, then out =
// (skip * valid) W_end + b_end [B, T, c_out] contiguous. 2 + 2 L launches,
// and one more to pack for k > 1.
template <class Tag>
cudaError_t forward(const float* x0, int ldx, const int* lens, const Weights& w, const Shape& sh,
                    const Dropout& drop, float* out, float* h, float* acts, float* skip, float* packed,
                    cudaStream_t s) {
  using namespace conv_rows;
  std::vector<const float*> win;
  cudaError_t err = pack_win<Tag, 1>(w, sh, packed, win, nullptr, s);
  if (err != cudaSuccess) return err;
  Weights wc = w;
  wc.win = win.data();
  err = forward_chain<Tag>(x0, ldx, lens, wc, sh, drop, h, 0, acts, 0, nullptr, 0, skip, s);
  if (err != cudaSuccess) return err;
  Args e{};
  e.lens = lens; e.T = sh.T; e.dil = 1;
  e.in = skip; e.ldi = sh.H; e.cin = sh.H; e.mask_in = 1;
  e.w = w.wend; e.bias = w.bend; e.n_out = sh.c_out; e.out = out; e.ldo = sh.c_out;
  return launch<Tag, 1, BIAS>(e, sh.B, s);
}

// The backward for the output cotangent g [B, T, c_out], up to the weight
// gradients: the dilated convs' weights packed into `packed`
// (packed_floats(sh, 2); both forms of each layer's), the recompute
// into the scratch, dskip = (g W_end^T) * valid, per layer in reverse the
// gate's derivative with the regenerated mask and
// dh_i = (dh_{i+1} + conv^T(dx_in, W_in)) * valid, and last
//   dx0 = (res + dh_0 W_s^T) * valid   (res rows ldres apart; 0 when null)
// into dx0 (rows ld_dx0 apart). 3 + 4 L launches, and one more to pack for k > 1.
template <class Tag>
cudaError_t backward_chain(const float* x0, int ldx, const int* lens, const float* g, const Weights& w,
                           const Shape& sh, const Dropout& drop, const Scratch& sc, const float* res, int ldres,
                           float* dx0, int ld_dx0, float* packed, cudaStream_t s) {
  using namespace conv_rows;
  const int B = sh.B, H = sh.H, L = sh.n_layers, k = sh.kernel_size;
  const size_t lay = (size_t)B * sh.T * H;
  std::vector<const float*> win_conv, win_t;
  cudaError_t err = pack_win<Tag, 2>(w, sh, packed, win_conv, &win_t, s);
  if (err != cudaSuccess) return err;
  Weights wc = w;
  wc.win = win_conv.data();
  err = forward_chain<Tag>(x0, ldx, lens, wc, sh, drop, sc.hs, lay, sc.acts, lay, sc.xin, 2 * lay, sc.skip,
                               s);
  if (err != cudaSuccess) return err;

  Args a{};
  a.lens = lens; a.T = sh.T; a.dil = 1; a.wt = 1; a.hidden = H;
  a.seed = drop.seed; a.threshold = drop.threshold; a.keep_scale = drop.keep_scale;
  a.stream_mul = WN_STREAMS; a.drop_ld = 2 * H;

  Args e = a;  // dskip = (g W_end^T) * valid
  e.in = g; e.ldi = sh.c_out; e.cin = sh.c_out; e.mask_in = 1;
  e.w = w.wend; e.n_out = H; e.out = sc.dskip; e.ldo = H;
  err = launch<Tag, 1, MASK>(e, B, s);
  if (err != cudaSuccess) return err;

  for (int i = L - 1; i >= 0; --i) {
    const bool last = i == L - 1;
    int dil = 1;
    for (int j = 0; j < i; ++j) dil *= sh.rate;
    float* dh_next = last ? nullptr : sc.dh + (i + 1) * lay;
    Args r = a;  // dacts = drs W_rs^T, then the gate's derivative and the mask
    if (last) {
      r.in = sc.dskip; r.ldi = H; r.cin = H;
    } else {
      r.in = dh_next; r.ldi = H; r.in2 = sc.dskip; r.ldi2 = H; r.split = H; r.cin = 2 * H;
    }
    r.w = w.wrs[i]; r.n_out = H; r.out = sc.dxin + 2 * i * lay; r.ldo = 2 * H;
    r.xin = sc.xin + 2 * i * lay; r.ldx = 2 * H; r.stream_add = i;
    err = launch<Tag, 1, GATE_BWD>(r, B, s);
    if (err != cudaSuccess) return err;

    Args c = a;  // dh_i = (dh_{i+1} + conv^T(dx_in, W_in)) * valid
    c.in = sc.dxin + 2 * i * lay; c.ldi = 2 * H; c.cin = 2 * H; c.mask_in = 1;
    c.w = win_t[i]; c.n_out = H; c.dil = dil; c.out = sc.dh + i * lay; c.ldo = H;
    if (last) {
      err = launch_taps<Tag, MASK>(k, c, B, s);
    } else {
      c.res = dh_next; c.ldr = H; c.hidden = 0;
      err = launch_taps<Tag, RES_SKIP>(k, c, B, s);
    }
    if (err != cudaSuccess) return err;
  }

  Args x = a;  // dx0 = (res + dh_0 W_s^T) * valid
  x.in = sc.dh; x.ldi = H; x.cin = H; x.mask_in = 1;
  x.w = w.ws; x.n_out = sh.half; x.out = dx0; x.ldo = ld_dx0;
  if (!res) return launch<Tag, 1, MASK>(x, B, s);
  x.res = res; x.ldr = ldres; x.hidden = 0;
  return launch<Tag, 1, RES_SKIP>(x, B, s);
}

// Every conditioner weight gradient as a reduction problem (pointers may be
// null when only the partials' size is wanted): W_end from (skip * valid, g),
// W_rs_i from (acts_i, [dh_{i+1}, dskip]), W_in_i from (h_i shifted by each
// tap, dx_in_i), W_s from (x0, dh_0); the biases are the column sums.
// fp32 only (wn_coupling_bwd.cu, flow_step_bwd.cu).
inline std::vector<wgrad_rows::Problem> problems(const float* x0, int ldx, const float* g, const Grads& d,
                                                 const Scratch& sc, const Shape& sh) {
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

// The flow step's prefix (ActNorm, then InvConvNear as one dense product):
//   xc = ((alb + exp(aln) * x) * valid) mt      x, xc [B, T, C] contiguous, mt [C, C]
// with the ActNorm in the tile loader and mt read as the transposed weight
// of a 1x1 conv. With x1 set, the loader's rows (the ActNorm's output, fp32)
// are written there too. One launch.
template <class Tag>
cudaError_t flow_prefix(const float* x, const int* lens, const float* aln, const float* alb, const float* mt,
                        int B, int T, int C, float* xc, float* x1, cudaStream_t s) {
  using namespace conv_rows;
  Args a{};
  a.lens = lens; a.T = T; a.dil = 1;
  a.in = x; a.ldi = C; a.cin = C; a.mask_in = 1; a.pre_logs = aln; a.pre_bias = alb;
  a.in_out = x1; a.ldio = C;
  a.w = mt; a.wt = 1; a.n_out = C; a.out = xc; a.ldo = C;
  return launch<Tag, 1, ACTNORM_FWD>(a, B, s);
}

}  // namespace wn_coupling
