// One Glow-TTS text-encoder layer forward for Hopper (sm_90a), fp32 at the
// interfaces, its products in 3xTF32 on the tensor cores, with dropout.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/enc_layer.py, function
// fused_enc_layer -> pallas_call(_fwd_kernel) (body _layer_fwd_body), for
// the windowed, bidirectional text-encoder layer, in its fp32 mode (the bf16
// mode, forward and backward, is enc_layer_bf16.cu). The recompute backward
// (its _vjp_bwd) is enc_layer_bwd.cu. Plain version:
// ops/enc_layer.py:enc_layer_reference.
//
// What it computes for x [B, T, C] with 2 heads of D = C / 2, window w:
//   xm = x * valid;  q, k, v = xm W_{q,k,v} + b
//   per head: s[i, j] = (q_i . k_j + [|j - i| <= w] q_i . R_k[j - i + w]) / sqrt(D),
//             -1e4 where i or j >= len (not -inf), p = softmax_j(s) * keep_P,
//             o_i = sum_j p[i, j] v_j + sum_{|j - i| <= w} p[i, j] R_v[j - i + w]
//   x1  = LN1(xm + (o W_o + b_o) * keep_Y)
//   f   = conv_k(relu(conv_k(x1 * valid, W_1) + b_1) * keep_M * valid, W_2) + b_2
//   out = LN2(x1 + f * valid * keep_F)
// with valid = t < lens[b], flax's LayerNorm (var = E[z^2] - E[z]^2, eps
// 1e-4) and the keep factors 1 without dropout, else the hash masks of
// enc_layer_common.cuh scaled by 1/(1-p). Rows at or past len give finite
// values that every consumer masks; the TPU kernel's softmax there is uniform
// over its padded width and this one's over T, so the two agree at valid
// rows only.
//
// What bounds it on an H100: operations. Per token the products cost about
// 2.06 MFLOP (QKV and W_o 4 x 2C^2, the two k=3 FFN convs 4 k C F) plus
// 4 T D per head for attention, against 1.5 KB of input and output: at
// (8, 256) about 4.6 GFLOP, 0.07 ms at 67 TFLOP/s of fp32 on the CUDA
// cores, 0.03 ms at 3 x 4.6 GFLOP over 495 TFLOP/s of TF32, 0.005 ms at
// 989 TFLOP/s in bf16.
//
// Design. One head's [T, T] scores are 1 MB at T=512, more than a block's
// 227 KB, so attention reuses B2's design (attention_fwd.cu): grid (32-row
// query tile, head, sequence), K and V streamed through shared memory in 32-key
// tiles, an online softmax per 16-key chunk, fp32 on the CUDA cores (a
// sixth of a call's time before the products moved: PERF.md). With D = 96
// a row is shared by 4 threads (24 dimensions each, partial dots summed with
// two shuffles), so q and o stay in registers. The relative-key term adds
// q_i . R_k[o] (nine dots per row, computed once) inside the band. The
// relative-value term needs the band's probabilities under the final max
// and sum: after the loop each row recomputes its 2w + 1 band scores from
// K, divides by the sum and adds them times R_v. Dropout multiplies each
// probability by its hash mask where it meets V or R_v (the sum l is of the
// undropped ones). The products around attention run on the tensor cores in
// 3xTF32 (conv_mma.cuh, each k-step's MMAs added in fp32), with the other
// three dropout sites, the residuals and the LayerNorms in conv_rows.cuh's
// epilogues: q|k|v as one 1x1 product against W_q, W_k and W_v packed as
// one [3C, C] weight (64-row tiles of 64 columns), W_o + LN1 and FFN conv 2
// + LN2 on tiles of 16 rows by the whole 192-channel row (the LayerNorm
// needs the row in one block), FFN conv 1 on 64-row tiles of 128 columns;
// the k=3 convs read each tap as a shifted k-slice of their input rows
// (x1 and the FFN's hidden rows go through device memory) against
// tap-major copies of W_1 and W_2. One call is 6 launches: the packing,
// q|k|v, attention, W_o + LN1, FFN conv 1, FFN conv 2 + LN2.

#include <cuda_runtime.h>

#include "enc_layer_common.cuh"

namespace {
struct LayerFwdTag {};
}  // namespace

// Floats of the workspace enc_layer_fwd needs (the packed weights), or -1
// for a shape the kernels do not take.
extern "C" long enc_layer_fwd_workspace_floats(int B, int T, int C, int n_heads, int window, int F,
                                               int kernel_size) {
  const enc_layer::Shape sh{B, T, C, n_heads, window, F, kernel_size, 0.0f};
  return enc_layer::valid_shape(sh) ? (long)enc_layer::packed_floats(sh, false) : -1;
}

// Launches the forward on `stream`; returns a cudaError_t (0 on success).
// x [B, T, C], lens, seed and the 18 weights (ops/enc_layer.py:PARAM_NAMES
// order, PyTorch's layouts) contiguous; outputs out [B, T, C] and the
// buffers qkv [B, T, 3C], att, x1 [B, T, C], hid [B, T, F]; `workspace`
// (enc_layer_fwd_workspace_floats).
extern "C" int enc_layer_fwd(const float* x, const int* lens, const long long* seed, const float* wq,
                             const float* bq, const float* wk, const float* bk, const float* wv,
                             const float* bv, const float* rk, const float* rv, const float* wo,
                             const float* bo, const float* g1, const float* be1, const float* w1,
                             const float* b1, const float* w2, const float* b2, const float* g2,
                             const float* be2, float* out, float* qkv, float* att, float* x1, float* hid,
                             float* workspace, int B, int T, int C, int n_heads, int window, int F,
                             int kernel_size, float eps, unsigned threshold, float keep_scale, void* stream) {
  const enc_layer::Shape sh{B, T, C, n_heads, window, F, kernel_size, eps};
  if (!enc_layer::valid_shape(sh)) return (int)cudaErrorInvalidValue;
  const enc_layer::Weights w{wq, bq, wk, bk, wv, bv, rk, rv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  enc_layer::Packed pk;
  const cudaError_t err = enc_layer::pack<LayerFwdTag>(w, sh, false, workspace, &pk, s);
  if (err != cudaSuccess) return (int)err;
  return (int)enc_layer::forward_chain<LayerFwdTag>(x, lens, w, pk, sh, {seed, threshold, keep_scale}, out, qkv,
                                                    att, nullptr, x1, nullptr, nullptr, hid, nullptr, nullptr, s);
}
