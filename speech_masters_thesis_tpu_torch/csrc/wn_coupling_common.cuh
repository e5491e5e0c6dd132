// The Glow-TTS coupling conditioner's forward chain, shared by the forward
// kernel (wn_coupling_fwd.cu) and the backward's recompute
// (wn_coupling_bwd.cu): the start 1x1, then per layer the dilated conv with
// dropout and the gate, and the res/skip 1x1, each a launch of
// conv_rows.cuh.
//
// Dropout of layer i's conv output (both halves, before the gate): stream
// b * WN_STREAMS + i, counter t * 2H + c (ops/wn_coupling.py:keep_mask).

#pragma once

#include <cuda_runtime.h>

#include "conv_rows.cuh"

namespace wn_coupling {

constexpr int WN_STREAMS = 64;  // ops/wn_coupling.py WN_STREAMS: at most this many layers

struct Weights {
  const float* ws;
  const float* bs;
  const float* const* win;
  const float* const* bin;
  const float* const* wrs;
  const float* const* brs;
};

struct Shape {
  int B, T, half, H, c_out, n_layers, kernel_size, rate;
};

struct Dropout {
  const long long* seed;
  unsigned threshold;
  float keep_scale;
};

inline bool valid_shape(const Shape& s) {
  return s.B >= 1 && s.B <= 65535 && s.T >= 1 && s.n_layers >= 1 && s.n_layers <= WN_STREAMS &&
         s.H >= 1 && s.half >= 1 && s.c_out >= 1 &&
         (s.kernel_size == 1 || s.kernel_size == 3 || s.kernel_size == 5);
}

// Layer i reads hs + i * hs_step and (i < n_layers - 1) writes hs + (i + 1) *
// hs_step (hs_step 0: h updated in place); its gate output goes to acts + i *
// acts_step and, when xin is set, its post-dropout conv output to xin + i *
// xin_step ([B, T, 2H]). The skip sum goes to skip.
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
  cudaError_t err = launch<Tag, 1, 32, 64, MASK>(a, sh.B, s);
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
    err = launch_taps<Tag, 32, 64, GATE>(sh.kernel_size, g, sh.B, s);
    if (err != cudaSuccess) return err;

    Args r = a;
    r.in = act; r.ldi = H; r.cin = H; r.mask_in = 0;
    r.w = w.wrs[i]; r.bias = w.brs[i]; r.n_out = i < sh.n_layers - 1 ? 2 * H : H;
    r.out = i < sh.n_layers - 1 ? hs + (i + 1) * hs_step : h; r.ldo = H; r.res = h; r.ldr = H;
    r.skip = skip; r.lds = H; r.first = i == 0;
    err = launch<Tag, 1, 32, 64, RES_SKIP>(r, sh.B, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace wn_coupling
