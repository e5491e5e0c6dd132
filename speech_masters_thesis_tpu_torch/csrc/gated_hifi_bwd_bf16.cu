// GatedHiFi block backward in bf16 for Hopper (sm_90a): the tile passes
// (gated_hifi_bwd_bf16) and the weight-gradient reduction
// (gated_hifi_wgrad_bf16), every product on wgmma with its operands staged
// by TMA (hopper.cuh). The fp32 mode stays in gated_hifi_bwd.cu.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/gated_hifi.py, function
// _vjp_bwd -> _bwd -> _bwd_kernel in its bf16 mode (dot_dtype = bf16; its
// weight sums at :360-454). The formulas are gated_hifi_bwd.cu's, with the
// TPU kernel's rounding points: every product's operands bf16, the sums
// fp32, everything between the products fp32.
//
// What this design does about the card, against the first bf16 form (the
// fp32 design's mma.sync tiles with one bf16 MMA a product):
//  * Cotangents in bf16. The tile passes store dzp's product copy, dc, dz
//    and gv in bf16, rounded to nearest even where the TPU kernel rounds
//    them at its dots (gv = g * [t < len] and dzp at res_scale 1 are exact
//    products of the rounding). Only zp / dzp stays fp32, for the gate and
//    the transposed conv's epilogue add. So no product stages fp32 or
//    converts in its k-loop, and the reduction reads nothing in fp32.
//  * Bias gradients from the epilogues. dball, dcb, db1 and dbg are column
//    sums of fp32 values the tile passes already hold (dz, dc, dzp, gv):
//    each 128-frame tile's epilogue adds its rows in a fixed order into one
//    row of a partial buffer [B * ceil(T / 128), 3 * depth * H + W], and
//    bias16_kernel adds the rows in a fixed order.
//  * TMA and wgmma. Activation slices come through 3-D tensor maps over
//    [B, T, C] with a conv tap's shift as the frame coordinate: the copy
//    fills zeros outside [0, T), so there is no halo window and no box
//    crosses into the next sequence. Weights come through 2-D maps. One
//    producer thread a consumer warpgroup feeds a ring of mbarrier-guarded
//    slots; the consumers run wgmma.m64nNk16 on them.
//
// Tile passes. One persistent kernel template over (128-frame tile,
// sequence, branch) items, a launch a stage, stages as gated_hifi_bwd.cu's:
//   1 expand  a_d  = relu(x Wall_d + ball_d) * m0          (recompute)
//   2 conv    h1_d = relu(sum_j a_d[t + (j-half) dil] K_d[j] + cb_d) * m1
//   3 branch  zp_d = h1_d W1_d + b1_d + x Wall_d + ball_d    (res_scale 1)
//   4 du      du = gv Wg^T, then gate16_kernel on the CUDA cores: gv, u,
//             dzp_d (fp32 in place and a bf16 copy), row by row
//   5 dc      dc_d = (dzp_d W1_d^T) * m1 * [h1 > 0]
//   6 convt   dz_d = dzp_d + (sum_j dc_d[t - (j-half) dil] K_d[j]^T) * m0 * [a > 0]
//   7 dx      dx = g * [t < len] + dz Wall^T
// An item's product is a 128 x BN tile (BN = 128, or 64 for du and dx) over
// k-slices of 64 channels, both operands K-major. The two consumer
// warpgroups take alternate items whole (two m64 halves each), each from
// its own ring, so that one's epilogue runs beside the other's products;
// one slice's products stay in flight while the next slice's issue. A block
// walks a contiguous run of the branch-major items whose cost (k-slices) is
// its share, so it stays on one or two branches; each slot carries its
// weight slice beside the activation slice (weights held in shared memory
// for a block's run on a branch saved about 1% of the tile passes, not
// worth a second barrier protocol: PERF.md §6). The epilogues
// stage each warp's accumulators through shared memory so that device
// memory sees whole rows (read and written in the accumulators' own layout
// they ran at about 0.5 TB/s). The recompute adds no per-k-step fp32 sums (as the first
// form), so a relu may flip at a near-tie against the forward.
//
// Reduction. out[m, n] = sum_frames X[t + shift, m] Y[t, n] with frames as
// the product's k: X^T is A and Y is B, both MN-major as they lie in
// device memory. A unit of work is one staged Y slab (64 frames, up to 256
// channels) against up to four 64-channel X slabs (a tap's shift is the X
// map's frame coordinate) and up to four 64 x 128 jobs (X slab, Y columns):
// a branch's conv taps go two to a unit against one dc slab, as the TPU
// kernel's _IM2COL stacks them. Each consumer warpgroup holds two jobs'
// accumulators. Units split over the frames by their cost; each block adds
// its accumulators into its fp32 partial every 1,024 frames (wgmma's
// accumulation truncates, wgmma_probe below), its loads of the partial
// batched (one at a time, the compiler ordering each after the last store,
// the adds cost 45% of the kernel), and wgrad16_reduce_kernel adds the
// partials in a fixed order and rounds each gradient to bf16 once. No
// float atomics anywhere: equal inputs give bitwise-equal outputs.
//
// What bounds it: at the VQ-VAE's 7 block shapes (16 x 65532 frames) the
// tile passes' products are 2.1 TFLOP (2.1 ms at 989 TF/s) and the
// reduction's 1.05 TFLOP (1.05 ms); the buffers between the stages move
// about 21 KB a frame in the tile passes (6.5 ms at 3.35 TB/s) and 5.5 KB a
// frame into the reduction (1.7 ms). Both are bound by bytes. The convs'
// weight slices, read again for each 128-frame item, are most of what moves
// between L2 and shared memory (PERF.md §6).

#include "gated_hifi_bf16.cuh"

#include <vector>

namespace gated_hifi {
namespace bwd16 {

constexpr int THREADS = 384;                 // warpgroup 0: producers; 1, 2: consumers
constexpr int A_BYTES = TM * KC * 2;         // an activation slice
constexpr int RED_BYTES = 2 * 2 * 4 * 128 * 4;  // the column sums' per-warp partials: 2 consumers x 2 sums x 4 warps
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536

constexpr int WB_BYTES = 8 * 16 * 36 * 4;     // the 8 consumer warps' epilogue staging buffers

// Shared memory of every stage: two rings of RING slots (an activation
// slice and its weight slice, up to 128 x 64), the epilogues' staging
// buffers, the column sums' partials, the barriers.
struct TileSmem {
  static constexpr int RING = 3;
  static constexpr int SLOT = A_BYTES + 128 * KC * 2;
  static constexpr int WB_OFF = 2 * RING * SLOT;
  static constexpr int RED_OFF = WB_OFF + WB_BYTES;
  static constexpr int BAR_OFF = RED_OFF + RED_BYTES;
  static constexpr int BYTES = BAR_OFF + 128 + 1024;  // + the 1024-byte alignment of the dynamic buffer
  static_assert(BYTES <= 232448, "tile passes: shared memory over the block limit");
};

template <int S>
__host__ __device__ __forceinline__ int branches_of(const Branches& br) {
  return (S == 4 || S == 7) ? 1 : br.depth;
}

template <int S>
__host__ __device__ __forceinline__ int n_slices(const Branches& br, int d) {
  switch (S) {
    case 2:
    case 6: return 2 * br.k[d];
    case 3: return 3;
    case 5: return 2;
    case 7: return 2 * br.depth;
    default: return 1;
  }
}

template <int S>
__host__ __device__ constexpr int stage_bn() { return (S == 4 || S == 7) ? 64 : 128; }

struct SliceSpec {
  const CUtensorMap* am;  // activation map: box at (channel ac, frame t0 + ash, sequence)
  int ac, ash;
  const CUtensorMap* bm;  // weight map: box at (k column bk, row bn)
  int bk, bn;
};

template <int S>
__device__ __forceinline__ SliceSpec slice(const TileParams& p, int d, int s) {
  const int half = (p.br.k[d] - 1) / 2, dil = p.br.dil[d], kr = p.br.k_off[d] / H;
  switch (S) {
    case 1: return {&p.m_x, 0, 0, &p.m_wall_t, 0, d * H};
    case 2:
      return {&p.m_a, d * H + KC * (s & 1), ((s >> 1) - half) * dil, &p.m_ks_t, KC * (s & 1), kr + (s >> 1) * H};
    case 3:
      return s < 2 ? SliceSpec{&p.m_h1, d * H + KC * s, 0, &p.m_w1_t, KC * s, d * H}
                   : SliceSpec{&p.m_x, 0, 0, &p.m_wall_t, 0, d * H};
    case 4: return {&p.m_g, 0, 0, &p.m_wg, 0, 0};
    case 5: return {&p.m_dzp, d * H + KC * s, 0, &p.m_w1, KC * s, d * H};
    case 6:
      return {&p.m_dc, d * H + KC * (s & 1), -((s >> 1) - half) * dil, &p.m_ks, KC * (s & 1), kr + (s >> 1) * H};
    default: return {&p.m_dz, KC * s, 0, &p.m_wall, KC * s, 0};
  }
}

// The items (branch d, l = b * ntt + tile) whose cost offset falls in this
// block's share [lo, hi): l in [l0, l1) of branch d.
struct Share {
  long long lo, hi;
  __device__ __forceinline__ void range(long long cum, int ns, int n_per, int& l0, int& l1) const {
    auto first = [&](long long at) {
      const long long r = at - cum;
      if (r <= 0) return 0;
      const long long l = (r + ns - 1) / ns;
      return l > n_per ? n_per : (int)l;
    };
    l0 = first(lo);
    l1 = first(hi);
  }
};

// A consumer's epilogue over its 128 x BN tile (acc[0] frames 0-63, acc[1]
// 64-127), one 16-frame x 32-column piece a warp at a time: the warp writes
// its piece of the accumulators (the wgmma layout: a thread holds two rows
// of column pairs) into its staging buffer, and reads it back so that each
// lane holds 4 adjacent columns of 4 frames. Device memory then sees whole
// rows: load(row, col, l) fetches what 4 columns of a frame need (16 bytes
// of fp32, 8 of bf16, 8 lanes a 128-byte row), the four frames' loads all
// in flight before f(v, row, col, l, s) computes, stores and adds what it
// sums into s[k][0..3]. (Read and written in the accumulators' own layout,
// each warp access touching 8 rows, the epilogues ran at about 0.5 TB/s.)
// Each sum k's tile total lands in out[k][0 .. BN) (skipped where out[k]
// is null), in a fixed order: a lane's 4 frames, the piece's 4 lanes of a
// column by shuffles, frames 0-63 then 64-127, the consumer's 4 warps.
constexpr int WB_LD = 36;  // floats a row of a warp's staging buffer: 32 and 4 of padding
template <int BN, int NS, class L, class Load, class F>
__device__ __forceinline__ void epilogue(float (&acc)[2][BN / 2], float* wbuf, float* red, int cons,
                                         float* const (&out)[NS > 0 ? NS : 1], Load load, F f) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;  // the consumer's warps 0..3
  const int g = lane >> 2, q2 = 2 * (lane & 3), rq = lane >> 3, cq = 4 * (lane & 7);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int cc = 0; cc < BN / 32; ++cc) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * (4 * cc + ii) + 2 * h;
          *reinterpret_cast<float2*>(wbuf + (g + 8 * h) * WB_LD + 8 * ii + q2) =
              make_float2(acc[mi][r], acc[mi][r + 1]);
        }
      __syncwarp();
      float v[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(wbuf + (rq + 4 * k) * WB_LD + cq);
        v[k][0] = x.x;
        v[k][1] = x.y;
        v[k][2] = x.z;
        v[k][3] = x.w;
      }
      __syncwarp();  // the buffer is free for the next piece
      const int row0 = 64 * mi + 16 * warp + rq, col = 32 * cc + cq;
      L l[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) load(row0 + 4 * k, col, l[k]);
      float s[NS > 0 ? NS : 1][4] = {};
#pragma unroll
      for (int k = 0; k < 4; ++k) f(v[k], row0 + 4 * k, col, l[k], s);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[n][j];
          x += __shfl_xor_sync(0xFFFFFFFFu, x, 8);
          x += __shfl_xor_sync(0xFFFFFFFFu, x, 16);
          float* q = red + (n * 4 + warp) * 128 + col + j;
          if (lane < 8) *q = mi ? *q + x : x;  // frames 0-63, then 64-127 added by the same lane
        }
    }
  }
  if constexpr (NS > 0) {
    named_sync(1 + cons, 128);
    const int c = threadIdx.x & 127;
#pragma unroll
    for (int k = 0; k < NS; ++k)
      if (c < BN && out[k] != nullptr) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) t += red[(k * 4 + w) * 128 + c];
        out[k][c] = t;
      }
    named_sync(1 + cons, 128);  // red is free for the next tile
  }
}

// 4 adjacent elements: loads (read-only ones through the non-coherent path)
// and stores, bf16 ones rounded to nearest even
__device__ __forceinline__ float4 ld4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 ld4(const bf16_t* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(bf16_t* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

struct Nothing {};
struct ConvtIn {
  float4 z, a;
};

// The stage's epilogue for one item: acc in the wgmma layout of this
// thread's warpgroup.
template <int S, int BN>
__device__ __forceinline__ void stage_epilogue(const TileParams& p, float (&acc)[2][BN / 2], float* wbuf, float* red,
                                               int cons, int d, int b, int t0, int tile) {
  const int T = p.T, ldw = p.br.depth * H;
  const size_t row0 = (size_t)b * T;
  float* bias_row = p.bias + (size_t)tile * p.nbias;
  float* const none[1] = {nullptr};
  auto no_load = [](int, int, Nothing&) {};
  if constexpr (S == 1 || S == 2) {
    const uint32_t key = p.drop.threshold ? dropout_key(p.drop.seed, b, d) : 0u;
    const bf16_t* bias = (S == 1 ? p.ball : p.cb) + d * H;
    epilogue<BN, 0, Nothing>(acc, wbuf, red, cons, none, no_load,
                             [&](float (&v)[4], int row, int c, Nothing&, float (&)[1][4]) {
      const int t = t0 + row;
      if (t >= T) return;
      const float4 bv = ld4(bias + c);
      float o[4] = {fmaxf(v[0] + bv.x, 0.f), fmaxf(v[1] + bv.y, 0.f), fmaxf(v[2] + bv.z, 0.f), fmaxf(v[3] + bv.w, 0.f)};
      if (p.drop.threshold) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] *= site_keep(dropout_bits(key, t, c + j), S == 1, p.drop);
      }
      st4((S == 1 ? p.a : p.h1) + (row0 + t) * ldw + d * H + c, o[0], o[1], o[2], o[3]);
    });
  } else if constexpr (S == 3) {
    epilogue<BN, 0, Nothing>(acc, wbuf, red, cons, none, no_load,
                             [&](float (&v)[4], int row, int c, Nothing&, float (&)[1][4]) {
      const int t = t0 + row;
      if (t >= T) return;
      const int n = d * H + c;
      const float4 b1 = ld4(p.b1 + n), ba = ld4(p.ball + n);
      st4(p.zp + (row0 + t) * ldw + n, v[0] + b1.x + ba.x, v[1] + b1.y + ba.y, v[2] + b1.z + ba.z,
          v[3] + b1.w + ba.w);
    });
  } else if constexpr (S == 4) {  // du = gv Wg^T (res_scale 1), zero past the length
    const int len = min(T, p.lens[b]);
    epilogue<BN, 0, Nothing>(acc, wbuf, red, cons, none, no_load,
                             [&](float (&v)[4], int row, int c, Nothing&, float (&)[1][4]) {
      const int t = t0 + row;
      if (t >= T) return;
      const bool valid = t < len;
      st4(p.du + (row0 + t) * W + c, valid ? v[0] : 0.f, valid ? v[1] : 0.f, valid ? v[2] : 0.f,
          valid ? v[3] : 0.f);
    });
  } else if constexpr (S == 5) {
    float* const out[1] = {bias_row + ldw + d * H};  // dcb
    auto load = [&](int row, int c, float4& h) {
      const int t = t0 + row;
      if (t < T) h = ld4(p.h1 + (row0 + t) * ldw + d * H + c);
    };
    epilogue<BN, 1, float4>(acc, wbuf, red, cons, out, load,
                            [&](float (&v)[4], int row, int c, float4& h, float (&s)[1][4]) {
      const int t = t0 + row;
      if (t >= T) return;
      const float hv[4] = {h.x, h.y, h.z, h.w};
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = hv[j] > 0.f ? v[j] * p.keep : 0.f;
        s[0][j] += o[j];
      }
      st4(p.dc16 + (row0 + t) * ldw + d * H + c, o[0], o[1], o[2], o[3]);
    });
  } else if constexpr (S == 6) {
    float* const out[2] = {bias_row + d * H, bias_row + 2 * ldw + d * H};  // dball, db1
    auto load = [&](int row, int c, ConvtIn& l) {
      const int t = t0 + row;
      if (t >= T) return;
      const size_t idx = (row0 + t) * ldw + d * H + c;
      l.z = ld4(p.zp + idx);
      l.a = ld4(p.a + idx);
    };
    epilogue<BN, 2, ConvtIn>(acc, wbuf, red, cons, out, load,
                             [&](float (&v)[4], int row, int c, ConvtIn& l, float (&s)[2][4]) {
      const int t = t0 + row;
      if (t >= T) return;
      const float zv[4] = {l.z.x, l.z.y, l.z.z, l.z.w}, av[4] = {l.a.x, l.a.y, l.a.z, l.a.w};
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = zv[j] + (av[j] > 0.f ? v[j] * p.keep : 0.f);
        s[0][j] += o[j];
        s[1][j] += zv[j];
      }
      st4(p.dz16 + (row0 + t) * ldw + d * H + c, o[0], o[1], o[2], o[3]);
    });
  } else {
    const int len = min(T, p.lens[b]);
    auto load = [&](int row, int c, float4& gg) {
      const int t = t0 + row;
      gg = t < len ? ld4(p.gp + (row0 + t) * W + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    epilogue<BN, 0, float4>(acc, wbuf, red, cons, none, load,
                            [&](float (&v)[4], int row, int c, float4& gg, float (&)[1][4]) {
      const int t = t0 + row;
      if (t >= T) return;
      st4(p.dx + (row0 + t) * W + c, v[0] + gg.x, v[1] + gg.y, v[2] + gg.z, v[3] + gg.w);
    });
  }
}

// gated_hifi_tiles.cuh's mix on (t, s) pairs already in x.tz, x.sz: the
// same operations in the same order, keeping each branch's tanh t and exp(s
// - m) (two adjacent channels each) for the gate's backward
__device__ __forceinline__ void mix_loaded(Mix& x, int depth, float2 (&th)[MAX_DEPTH], float2 (&ex)[MAX_DEPTH]) {
  x.m[0] = x.m[1] = -INFINITY;
#pragma unroll
  for (int dd = 0; dd < MAX_DEPTH; ++dd) {
    if (dd >= depth) break;
    x.m[0] = fmaxf(x.m[0], x.sz[dd].x);
    x.m[1] = fmaxf(x.m[1], x.sz[dd].y);
  }
  float num[2] = {0.f, 0.f};
  x.den[0] = x.den[1] = 0.f;
#pragma unroll
  for (int dd = 0; dd < MAX_DEPTH; ++dd) {
    if (dd >= depth) break;
    const float e0 = expf(x.sz[dd].x - x.m[0]), e1 = expf(x.sz[dd].y - x.m[1]);
    th[dd] = make_float2(tanhf(x.tz[dd].x), tanhf(x.tz[dd].y));
    ex[dd] = make_float2(e0, e1);
    x.den[0] += e0;
    x.den[1] += e1;
    num[0] += th[dd].x * e0;
    num[1] += th[dd].y * e1;
  }
  x.u[0] = num[0] / x.den[0];
  x.u[1] = num[1] / x.den[1];
}

// 4b. The gate's elementwise part on the CUDA cores, whole rows at a time:
// from du (stage 4's product) and every branch's zp, u and gv, and dzp_d
// (fp32 over zp in place, and its bf16 copy); dbg's column sums of the
// 128-frame tile. A block a tile; warp w takes frames w, w + 8, ..., lane l
// gate columns 2l, 2l + 1 of each (so a warp's access is a 256-byte run of
// fp32). Two frames' loads are in flight before either is computed.
constexpr int GATE_THREADS = 256;
__global__ void __launch_bounds__(GATE_THREADS) gate16_kernel(const __grid_constant__ TileParams p) {
  __shared__ float part[GATE_THREADS / 32][W];
  const int T = p.T, ldw = p.br.depth * H, depth = p.br.depth;
  const int b = blockIdx.x / p.ntt, t0 = (blockIdx.x % p.ntt) * TM;
  const int warp = threadIdx.x >> 5, c = 2 * (threadIdx.x & 31);
  const int len = min(T, p.lens[b]);
  float sg[2] = {0.f, 0.f};
  for (int r0 = warp; r0 < TM; r0 += 2 * (GATE_THREADS / 32)) {
    Mix mx[2];
    float2 du[2], gg[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = t0 + r0 + k * (GATE_THREADS / 32);
      if (t >= T) continue;
      const size_t row = (size_t)b * T + t;
      du[k] = ld2(p.du + row * W + c);
      gg[k] = t < len ? ld2(p.gp + row * W + c) : make_float2(0.f, 0.f);
      const float* zrow = p.zp + row * ldw + c;
#pragma unroll
      for (int dd = 0; dd < MAX_DEPTH; ++dd) {
        if (dd >= depth) break;
        mx[k].tz[dd] = ld2(zrow + dd * H);
        mx[k].sz[dd] = ld2(zrow + dd * H + W);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = t0 + r0 + k * (GATE_THREADS / 32);
      if (t >= T) continue;
      const size_t row = (size_t)b * T + t;
      st2(p.gv + row * W + c, gg[k].x, gg[k].y);  // exact: bf16 g times 0 or 1
      sg[0] += gg[k].x;
      sg[1] += gg[k].y;
      float2 th[MAX_DEPTH], ex[MAX_DEPTH];
      mix_loaded(mx[k], depth, th, ex);
      st2(p.u + row * W + c, mx[k].u[0], mx[k].u[1]);
      float* zrow = p.zp + row * ldw + c;
      bf16_t* zrow16 = p.dzp16 + row * ldw + c;
      const float dv[2] = {du[k].x, du[k].y};
#pragma unroll
      for (int dd = 0; dd < MAX_DEPTH; ++dd) {
        if (dd >= depth) break;
        const float thv[2] = {th[dd].x, th[dd].y}, exv[2] = {ex[dd].x, ex[dd].y};
        float dt[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pj = exv[j] / mx[k].den[j];
          dt[j] = dv[j] * pj * (1.f - thv[j] * thv[j]);
          ds[j] = dv[j] * pj * (thv[j] - mx[k].u[j]);
        }
        st2(zrow + dd * H, dt[0], dt[1]);
        st2(zrow + dd * H + W, ds[0], ds[1]);
        st2(zrow16 + dd * H, dt[0], dt[1]);
        st2(zrow16 + dd * H + W, ds[0], ds[1]);
      }
    }
  }
  part[warp][c] = sg[0];
  part[warp][c + 1] = sg[1];
  __syncthreads();
  if (threadIdx.x < W) {  // dbg: the warps' partials in order
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < GATE_THREADS / 32; ++w) t += part[w][threadIdx.x];
    p.bias[(size_t)blockIdx.x * p.nbias + 3 * ldw + threadIdx.x] = t;
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1) tile_kernel(const __grid_constant__ TileParams p) {
  using G = TileSmem;
  constexpr int BN = stage_bn<S>();
  constexpr int BSLICE = BN * KC * 2;  // bytes of a weight slice
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);  // [consumer][slot]
  uint64_t* const empty = full + 2 * G::RING;

  const int nb = branches_of<S>(p.br), n_per = p.B * p.ntt;
  long long total = 0;
  for (int d = 0; d < nb; ++d) total += (long long)n_per * n_slices<S>(p.br, d);
  const Share share{total * blockIdx.x / gridDim.x, total * (blockIdx.x + 1) / gridDim.x};

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * G::RING; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Items alternate between the two consumers (the block's n-th item goes to
  // consumer n % 2), each fed through a ring of its own by a producer thread
  // of its own (warps 0 and 1 of warpgroup 0): while one consumer runs an
  // item's epilogue, the other's products run.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if ((threadIdx.x & 31) != 0 || threadIdx.x >= 64) return;
    const int c = threadIdx.x >> 5;
    RingPos pos;
    int n = 0;
    long long cum = 0;
    for (int d = 0; d < nb; ++d) {
      const int ns = n_slices<S>(p.br, d);
      int l0, l1;
      share.range(cum, ns, n_per, l0, l1);
      cum += (long long)n_per * ns;
      if (l0 >= l1) continue;
      for (int l = l0; l < l1; ++l, ++n) {
        if ((n & 1) != c) continue;
        const int b = l / p.ntt, t0 = (l % p.ntt) * TM;
        for (int s = 0; s < ns; ++s) {
          const SliceSpec sp = slice<S>(p, d, s);
          uint64_t* const f = &full[c * G::RING + pos.slot];
          mbar_wait(&empty[c * G::RING + pos.slot], pos.phase ^ 1u);
          uint8_t* const st = sm + (c * G::RING + pos.slot) * G::SLOT;
          mbar_expect_tx(f, A_BYTES + BSLICE);
          tma_load_3d(st, sp.am, f, sp.ac, t0 + sp.ash, b);
          tma_load_2d(st + A_BYTES, sp.bm, f, sp.bk, sp.bn);
          pos.next(G::RING);
        }
      }
    }
    return;
  }

  // consumer c: whole 128-frame items, frames 0-63 in acc[0] and 64-127 in acc[1]
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = (threadIdx.x >> 7) - 1;
  const bool lead = (threadIdx.x & 127) == 0;
  float* const red = reinterpret_cast<float*>(sm + G::RED_OFF) + c * (RED_BYTES / 8);
  float* const wbuf = reinterpret_cast<float*>(sm + G::WB_OFF) + ((threadIdx.x >> 5) - 4) * 16 * WB_LD;
  RingPos pos;
  int n = 0;
  long long cum = 0;
  for (int d = 0; d < nb; ++d) {
    const int ns = n_slices<S>(p.br, d);
    int l0, l1;
    share.range(cum, ns, n_per, l0, l1);
    cum += (long long)n_per * ns;
    if (l0 >= l1) continue;
    for (int l = l0; l < l1; ++l, ++n) {
      if ((n & 1) != c) continue;
      const int b = l / p.ntt, t0 = (l % p.ntt) * TM;
      float acc[2][BN / 2];
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) acc[0][r] = acc[1][r] = 0.f;
      // one slice's products stay in flight while the next slice's are
      // issued; a slot is released once the products that read it are done
      int prev = -1;
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      for (int s = 0; s < ns; ++s) {
        mbar_wait(&full[c * G::RING + pos.slot], pos.phase);
        const uint8_t* st = sm + (c * G::RING + pos.slot) * G::SLOT;
        const uint32_t a_addr = smem_u32(st);
        const uint32_t b_addr = smem_u32(st + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          const uint64_t bd = desc_b128(b_addr + 32 * kk, 16, 1024);
          mma_k16<BN, 0, 0>(acc[0], desc_b128(a_addr + 32 * kk, 16, 1024), bd);
          mma_k16<BN, 0, 0>(acc[1], desc_b128(a_addr + 64 * 128 + 32 * kk, 16, 1024), bd);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (lead && prev >= 0) mbar_arrive(&empty[c * G::RING + prev]);
        prev = pos.slot;
        pos.next(G::RING);
      }
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (lead && prev >= 0) mbar_arrive(&empty[c * G::RING + prev]);
      stage_epilogue<S, BN>(p, acc, wbuf, red, c, d, b, t0, l);
    }
  }
}

// ---- the reduction ----------------------------------------------------------
constexpr int RF = 64;                     // frames a slab
constexpr int RSTAGES = 4;                 // slabs in flight
constexpr int RCHUNKS = 6;                 // 64-channel chunks a slot holds: Y's, then X's
constexpr int CHUNK = RF * 128;            // bytes of a chunk
constexpr int RSLOT = RCHUNKS * CHUNK;
constexpr int RBAR_OFF = RSTAGES * RSLOT;
constexpr int RED_SMEM = RBAR_OFF + 64 + 1024;
constexpr int FLUSH = 1024 / RF;           // slabs between two adds into the partial
constexpr int MAX_UNITS = 24;
constexpr int JOB_FLOATS = 64 * 128;       // a job's partial: its accumulators in their own order
constexpr int MAPS = 8;                    // x, a, h1, u, dc, dzp, dz, gv
static_assert(RED_SMEM <= 232448, "reduction: shared memory over the block limit");

struct RX {  // an X slab: 64 channels at c0 of map `map`, frames shifted
  int16_t c0;
  int8_t map, pad;
  int32_t shift;
};
struct RJob {  // X slab xs against Y chunks ych, ych + 1; out[m * ldo + n], n < ncols
  int8_t xs, ych;
  int16_t ncols;
  int32_t out, ldo;
};
struct RUnit {
  int8_t ymap, ych, nx, njobs;  // Y: ych chunks from channel yc0 of map ymap
  int16_t yc0, n_split;
  int32_t block0;               // the unit's first block; its partials follow
  RX x[4];
  RJob job[4];
};
struct RParams {
  CUtensorMap maps[MAPS];
  RUnit unit[MAX_UNITS];
  float* partials;
  bf16_t* grads;
  int B, T, nts, n_units;
};

__device__ __forceinline__ int unit_of(const RParams& p, int block) {
  int u = 0;
  while (u + 1 < p.n_units && block >= p.unit[u + 1].block0) ++u;
  return u;
}

__global__ void __launch_bounds__(THREADS, 1) wgrad16_kernel(const __grid_constant__ RParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + RBAR_OFF);
  uint64_t* const empty = full + RSTAGES;
  const RUnit& U = p.unit[unit_of(p, blockIdx.x)];
  const int split = blockIdx.x - U.block0;
  const long long n_slabs = (long long)p.B * p.nts;
  const long long chunk = (n_slabs + U.n_split - 1) / U.n_split;
  const long long s0 = split * chunk, s1 = s0 + chunk < n_slabs ? s0 + chunk : n_slabs;

  if (threadIdx.x == 0) {
    for (int i = 0; i < RSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x != 0) return;
    RingPos pos;
    const int ych = U.ych, nx = U.nx;
    for (long long s = s0; s < s1; ++s) {
      const int b = (int)(s / p.nts), t0 = (int)(s % p.nts) * RF;
      mbar_wait(&empty[pos.slot], pos.phase ^ 1u);
      uint8_t* const st = sm + pos.slot * RSLOT;
      mbar_expect_tx(&full[pos.slot], (ych + nx) * CHUNK);
      for (int c = 0; c < ych; ++c) tma_load_3d(st + c * CHUNK, &p.maps[U.ymap], &full[pos.slot], U.yc0 + KC * c, t0, b);
      for (int x = 0; x < nx; ++x)
        tma_load_3d(st + (ych + x) * CHUNK, &p.maps[U.x[x].map], &full[pos.slot], U.x[x].c0, t0 + U.x[x].shift, b);
      pos.next(RSTAGES);
    }
    return;
  }

  const int cw = (threadIdx.x >> 7) - 1, t = threadIdx.x & 127;
  const bool two = cw + 2 < U.njobs;  // this warpgroup's jobs: cw and cw + 2
  const bool any = cw < U.njobs;
  float acc0[64], acc1[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc0[r] = acc1[r] = 0.f;
  float2* const part = reinterpret_cast<float2*>(p.partials) + (size_t)blockIdx.x * 4 * (JOB_FLOATS / 2) + t;
  // the partial's old values 8 pairs at a time, all in flight before the
  // stores (which the compiler would otherwise order after each load)
  auto flush = [&](float (&acc)[64], int j, bool first) {
    float2* q = part + (size_t)j * (JOB_FLOATS / 2);
#pragma unroll
    for (int p0 = 0; p0 < 32; p0 += 8) {
      float2 o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = first ? make_float2(0.f, 0.f) : q[(p0 + i) * 128];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int pr = p0 + i;
        q[pr * 128] = first ? make_float2(acc[2 * pr], acc[2 * pr + 1])
                            : make_float2(o[i].x + acc[2 * pr], o[i].y + acc[2 * pr + 1]);
        acc[2 * pr] = acc[2 * pr + 1] = 0.f;
      }
    }
  };
  RingPos pos;
  int n = 0;
  bool first = true;
  for (long long s = s0; s < s1; ++s) {
    mbar_wait(&full[pos.slot], pos.phase);
    const uint32_t st = smem_u32(sm + pos.slot * RSLOT);
    if (any) {
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
      const RJob j0 = U.job[cw];
      const uint32_t xa = st + (U.ych + j0.xs) * CHUNK, yb = st + j0.ych * CHUNK;
#pragma unroll
      for (int kk = 0; kk < RF / 16; ++kk)
        mma_k16<128, 1, 1>(acc0, desc_b128(xa + 2048 * kk, CHUNK, 1024), desc_b128(yb + 2048 * kk, CHUNK, 1024));
      if (two) {
        const RJob j1 = U.job[cw + 2];
        const uint32_t xa1 = st + (U.ych + j1.xs) * CHUNK, yb1 = st + j1.ych * CHUNK;
#pragma unroll
        for (int kk = 0; kk < RF / 16; ++kk)
          mma_k16<128, 1, 1>(acc1, desc_b128(xa1 + 2048 * kk, CHUNK, 1024), desc_b128(yb1 + 2048 * kk, CHUNK, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
    }
    if (t == 0) mbar_arrive(&empty[pos.slot]);
    pos.next(RSTAGES);
    if (any && (++n % FLUSH == 0 || s + 1 == s1)) {
      flush(acc0, cw, first);
      if (two) flush(acc1, cw + 2, first);
      first = false;
    }
  }
  if (s0 >= s1 && any) {  // an empty share: zeros
    flush(acc0, cw, true);
    if (two) flush(acc1, cw + 2, true);
  }
}

// the partials added in a fixed order, each gradient stored once in bf16
__global__ void __launch_bounds__(256) wgrad16_reduce_kernel(const __grid_constant__ RParams p) {
  const RUnit& U = p.unit[blockIdx.z];
  const int j = blockIdx.y;
  if (j >= U.njobs) return;
  const int e = blockIdx.x * 256 + threadIdx.x;  // 0 .. 64 * 128
  const int m = e >> 7, n = e & 127;
  if (n >= U.job[j].ncols) return;
  // where the accumulators keep (m, n): thread (m / 16) * 32 + (m % 8) * 4 + (n % 8) / 2 of the
  // warpgroup, register 4 (n / 8) + 2 ((m % 16) / 8) + n % 2
  const int th = (m >> 4) * 32 + (m & 7) * 4 + ((n & 7) >> 1);
  const int pr = 2 * (n >> 3) + ((m >> 3) & 1);
  const int at = (pr * 128 + th) * 2 + (n & 1);
  const float* src = p.partials + (size_t)U.block0 * 4 * JOB_FLOATS + (size_t)j * JOB_FLOATS + at;
  float sum = 0.f;
  for (int s = 0; s < U.n_split; ++s) sum += src[(size_t)s * 4 * JOB_FLOATS];
  p.grads[U.job[j].out + (size_t)m * U.job[j].ldo + n] = __float2bfloat16_rn(sum);
}

// The bias gradients: the column sums' tile partials [rows, ncols] added
// in a fixed order (32 strided runs of rows, then the runs in order) and
// rounded to bf16 once; columns [0, ldb) go to dball, [ldb, 2 ldb) dcb,
// [2 ldb, 3 ldb) db1, the last W dbg.
__global__ void __launch_bounds__(1024) bias16_kernel(const float* __restrict__ part, int rows, int ncols, int ldb,
                                                      bf16_t* dball, bf16_t* dcb, bf16_t* db1, bf16_t* dbg) {
  __shared__ float s[32][33];
  const int cx = threadIdx.x & 31, r = threadIdx.x >> 5, c = blockIdx.x * 32 + cx;
  float v = 0.f;
  if (c < ncols) {
#pragma unroll 8
    for (int i = r; i < rows; i += 32) v += part[(size_t)i * ncols + c];
  }
  s[r][cx] = v;
  __syncthreads();
  if (r == 0 && c < ncols) {
    float t = 0.f;
    for (int k = 0; k < 32; ++k) t += s[k][cx];
    bf16_t* out = c < ldb ? dball + c : c < 2 * ldb ? dcb + (c - ldb) : c < 3 * ldb ? db1 + (c - 2 * ldb)
                                                                                : dbg + (c - 3 * ldb);
    *out = __float2bfloat16_rn(t);
  }
}

// ---- host ---------------------------------------------------------------------
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// a [B, T, C] bf16 activation map read in boxes of 64 channels x `frames`
bool act_map(CUtensorMap* m, const void* base, int B, int T, int C, int frames) {
  return bf16_map(m, base, C, T, B, (uint64_t)C * 2, (uint64_t)T * C * 2, KC, frames);
}

// a [rows, cols] bf16 weight map read in boxes of 64 columns x `box_rows`
bool weight_map(CUtensorMap* m, const void* base, int rows, int cols, int box_rows) {
  return bf16_map(m, base, cols, rows, 0, (uint64_t)cols * 2, 0, KC, box_rows);
}

template <int S>
cudaError_t launch_tiles(const TileParams& p, cudaStream_t s) {
  constexpr int smem = TileSmem::BYTES;
  cudaError_t err = cudaFuncSetAttribute(tile_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)branches_of<S>(p.br) * p.B * p.ntt;
  const int grid = (int)(items < sm_count() ? items : sm_count());
  tile_kernel<S><<<grid, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// the forward (gated_hifi_fwd_bf16.cu) runs stage 1 as it is
template cudaError_t launch_tiles<1>(const TileParams& p, cudaStream_t s);

int backward(const bf16_t* x, const int* lens, const bf16_t* g, const bf16_t* wall, const bf16_t* ball,
             const bf16_t* ks, const bf16_t* cb, const bf16_t* w1, const bf16_t* b1, const bf16_t* wg,
             const bf16_t* w1_t, const bf16_t* ks_t, const bf16_t* wall_t, bf16_t* a, bf16_t* h1, float* zp,
             float* du, bf16_t* dzp16, bf16_t* dc16, bf16_t* dz16, bf16_t* u, bf16_t* gv, float* bias, bf16_t* dx,
             int B, int T,
             int width, int depth, const int* kernels, const int* dilations, float scale, unsigned seed,
             unsigned threshold, float keep_scale, void* stream) {
  TileParams p{};
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (width != W || B < 1 || T < 1 || scale != 1.f || !make_branches(depth, kernels, dilations, &p.br) ||
      sm_count() < 1 || !aligned(ball) || !aligned(cb) || !aligned(b1) || !aligned(g))
    return (int)cudaErrorInvalidValue;
  const int ldw = depth * H, taps_rows = p.br.k_off[depth - 1] / H + p.br.k[depth - 1] * H;
  bool ok = act_map(&p.m_x, x, B, T, W, TM) && act_map(&p.m_g, g, B, T, W, TM) &&
            act_map(&p.m_a, a, B, T, ldw, TM) && act_map(&p.m_h1, h1, B, T, ldw, TM) &&
            act_map(&p.m_dzp, dzp16, B, T, ldw, TM) && act_map(&p.m_dc, dc16, B, T, ldw, TM) &&
            act_map(&p.m_dz, dz16, B, T, ldw, TM);
  ok = ok && weight_map(&p.m_wall_t, wall_t, ldw, W, 128) && weight_map(&p.m_ks_t, ks_t, taps_rows, H, 128) &&
       weight_map(&p.m_w1_t, w1_t, ldw, H, 128) && weight_map(&p.m_wg, wg, W, W, 64) &&
       weight_map(&p.m_w1, w1, ldw, H, 128) && weight_map(&p.m_ks, ks, taps_rows, H, 128) &&
       weight_map(&p.m_wall, wall, W, ldw, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  p.gp = g;
  p.ball = ball;
  p.cb = cb;
  p.b1 = b1;
  p.lens = lens;
  p.a = a;
  p.h1 = h1;
  p.u = u;
  p.dzp16 = dzp16;
  p.dc16 = dc16;
  p.dz16 = dz16;
  p.gv = gv;
  p.dx = dx;
  p.zp = zp;
  p.du = du;
  p.bias = bias;
  p.B = B;
  p.T = T;
  p.ntt = (T + TM - 1) / TM;
  p.nbias = 3 * ldw + W;
  p.keep = threshold ? keep_scale : 1.f;
  p.drop = Dropout{seed, threshold, keep_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // in stream order: each stage reads what the ones before it wrote
  cudaError_t err = launch_tiles<1>(p, s);
  if (err == cudaSuccess) err = launch_tiles<2>(p, s);
  if (err == cudaSuccess) err = launch_tiles<3>(p, s);
  if (err == cudaSuccess) err = launch_tiles<4>(p, s);
  if (err == cudaSuccess) {
    gate16_kernel<<<B * p.ntt, GATE_THREADS, 0, s>>>(p);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = launch_tiles<5>(p, s);
  if (err == cudaSuccess) err = launch_tiles<6>(p, s);
  if (err == cudaSuccess) err = launch_tiles<7>(p, s);
  return (int)err;
}

enum Map { MX, MA, MH1, MU, MDC, MDZP, MDZ, MGV };

// The reduction's units (gated_hifi_bwd_bf16.cu's header) at the packed
// gradients' offsets, each with its frame splits and first block.
std::vector<RUnit> units(const Branches& br, long long n_slabs) {
  const int depth = br.depth, ldw = depth * H;
  int taps = 0;
  for (int d = 0; d < depth; ++d) taps += br.k[d];
  const int o_wall = 0, o_ks = W * ldw + ldw, o_w1 = o_ks + taps * H * H + ldw, o_wg = o_w1 + depth * H * H + ldw;
  std::vector<RUnit> us;
  for (int d = 0; d < depth; ++d) {
    const int half = (br.k[d] - 1) / 2;
    for (int j = 0; j < br.k[d]; j += 2) {  // taps j, j + 1 against one dc slab
      RUnit u{};
      u.ymap = MDC;
      u.ych = 2;
      u.yc0 = (int16_t)(d * H);
      const int nt = j + 1 < br.k[d] ? 2 : 1;
      for (int tt = 0; tt < nt; ++tt)
        for (int mh = 0; mh < 2; ++mh) {
          const int xi = 2 * tt + mh;
          u.x[xi] = RX{(int16_t)(d * H + 64 * mh), (int8_t)MA, 0, (j + tt - half) * br.dil[d]};
          // jobs ordered so that warpgroup mh takes both taps' rows 64 mh ..
          u.job[2 * tt + mh] = RJob{(int8_t)xi, 0, (int16_t)H, o_ks + br.k_off[d] + (j + tt) * H * H + 64 * mh * H, H};
        }
      u.nx = u.njobs = (int8_t)(2 * nt);
      us.push_back(u);
    }
  }
  for (int d = 0; d < depth; ++d) {  // h1^T dzp
    RUnit u{};
    u.ymap = MDZP;
    u.ych = 2;
    u.yc0 = (int16_t)(d * H);
    for (int mh = 0; mh < 2; ++mh) {
      u.x[mh] = RX{(int16_t)(d * H + 64 * mh), (int8_t)MH1, 0, 0};
      u.job[mh] = RJob{(int8_t)mh, 0, (int16_t)H, o_w1 + d * H * H + 64 * mh * H, H};
    }
    u.nx = u.njobs = 2;
    us.push_back(u);
  }
  {  // u^T gv: gv is 64 wide, so its second chunk reads zeros
    RUnit u{};
    u.ymap = MGV;
    u.ych = 2;
    u.x[0] = RX{0, (int8_t)MU, 0, 0};
    u.job[0] = RJob{0, 0, (int16_t)W, o_wg, W};
    u.nx = u.njobs = 1;
    us.push_back(u);
  }
  for (int c0 = 0; c0 < ldw; c0 += 256) {  // x^T dz, 256 columns a unit
    RUnit u{};
    u.ymap = MDZ;
    u.yc0 = (int16_t)c0;
    const int cols = ldw - c0 < 256 ? ldw - c0 : 256;
    u.ych = (int8_t)((cols + 63) / 64);
    u.x[0] = RX{0, (int8_t)MX, 0, 0};
    u.nx = 1;
    for (int jj = 0; jj * 128 < cols; ++jj)
      u.job[jj] = RJob{0, (int8_t)(2 * jj), (int16_t)(cols - 128 * jj < 128 ? cols - 128 * jj : 128),
                       o_wall + c0 + 128 * jj, ldw};
    u.njobs = (int8_t)((cols + 127) / 128);
    us.push_back(u);
  }
  // frame splits by cost (jobs' products and chunks' bytes), about two
  // blocks an SM in all, at most one a slab
  double cost = 0.0;
  for (const RUnit& u : us) cost += 4.0 * u.njobs + u.ych + u.nx;
  const double target = 2.0 * (sm_count() > 0 ? sm_count() : 132);
  int block = 0;
  for (RUnit& u : us) {
    long long n = (long long)(target * (4.0 * u.njobs + u.ych + u.nx) / cost + 0.5);
    n = n < 1 ? 1 : n > n_slabs ? n_slabs : n;
    n = n > 32767 ? 32767 : n;
    u.n_split = (int16_t)n;
    u.block0 = block;
    block += (int)n;
  }
  return us;
}

// floats of the partials buffer: the largest launch's blocks x 4 jobs
long partial_floats(const Branches& br, long long n_slabs) {
  const std::vector<RUnit> us = units(br, n_slabs);
  long most = 0;
  for (size_t u0 = 0; u0 < us.size(); u0 += MAX_UNITS) {
    const size_t u1 = u0 + MAX_UNITS < us.size() ? u0 + MAX_UNITS : us.size();
    const long blocks = us[u1 - 1].block0 + us[u1 - 1].n_split - us[u0].block0;
    most = blocks > most ? blocks : most;
  }
  return most * 4 * JOB_FLOATS;
}

int wgrad(const bf16_t* x, const bf16_t* a, const bf16_t* h1, const bf16_t* dzp16, const bf16_t* dc16,
          const bf16_t* dz16, const bf16_t* u, const bf16_t* gv, const float* bias, float* partials, bf16_t* grads,
          int B, int T, int width, int depth, const int* kernels, const int* dilations, float scale, void* stream) {
  Branches br;
  if (width != W || B < 1 || T < 1 || scale != 1.f || !make_branches(depth, kernels, dilations, &br) ||
      sm_count() < 1)
    return (int)cudaErrorInvalidValue;
  const int ldw = depth * H;
  RParams p{};
  p.B = B;
  p.T = T;
  p.nts = (T + RF - 1) / RF;
  p.partials = partials;
  p.grads = grads;
  const bf16_t* bases[MAPS] = {x, a, h1, u, dc16, dzp16, dz16, gv};
  const int widths[MAPS] = {W, ldw, ldw, W, ldw, ldw, ldw, W};
  for (int i = 0; i < MAPS; ++i)
    if (!act_map(&p.maps[i], bases[i], B, T, widths[i], RF)) return (int)cudaErrorInvalidValue;
  const std::vector<RUnit> us = units(br, (long long)B * p.nts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(wgrad16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RED_SMEM);
  for (size_t u0 = 0; u0 < us.size() && err == cudaSuccess; u0 += MAX_UNITS) {
    const size_t u1 = u0 + MAX_UNITS < us.size() ? u0 + MAX_UNITS : us.size();
    p.n_units = (int)(u1 - u0);
    const int first = us[u0].block0;
    for (size_t i = u0; i < u1; ++i) {
      p.unit[i - u0] = us[i];
      p.unit[i - u0].block0 -= first;
    }
    const int blocks = p.unit[p.n_units - 1].block0 + p.unit[p.n_units - 1].n_split;
    wgrad16_kernel<<<blocks, THREADS, RED_SMEM, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    wgrad16_reduce_kernel<<<dim3(JOB_FLOATS / 256, 4, p.n_units), 256, 0, s>>>(p);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  int taps = 0;
  for (int d = 0; d < depth; ++d) taps += br.k[d];
  bf16_t* dball = grads + W * ldw;
  bf16_t* dcb = dball + ldw + (size_t)taps * H * H;
  bf16_t* db1 = dcb + ldw + (size_t)depth * H * H;
  bf16_t* dbg = db1 + ldw + W * W;
  const int ncols = 3 * ldw + W, rows = B * ((T + TM - 1) / TM);
  bias16_kernel<<<(ncols + 31) / 32, 1024, 0, s>>>(bias, rows, ncols, ldw, dball, dcb, db1, dbg);
  return (int)cudaGetLastError();
}

// ---- the wgmma probe ------------------------------------------------------------
// One warpgroup. (1) The accumulation: d = +-1 from the accumulators, plus
// one product of 0.75 ulp (K-major operands). (2) Both layouts this file
// uses, 64 x 128 x 64 products of small integers (exact in fp32) against
// FMA sums: K-major A and B, then MN-major A and B (B in two 64-column
// tiles, LBO apart). (3) A K-major A read from 3 rows into its tile, as a
// window of frames shared by a conv's taps would be read: the swizzle
// follows the address, so the descriptor's base offset stays 0.
__global__ void __launch_bounds__(128) wgmma_probe_kernel(float* out) {
  __shared__ __align__(1024) uint8_t s[48 * 1024];
  bf16_t* const ak = reinterpret_cast<bf16_t*>(s);              // K-major A: 64 rows m x 64 k
  bf16_t* const bk = reinterpret_cast<bf16_t*>(s + 8192);       // K-major B: 128 rows n x 64 k
  bf16_t* const am = reinterpret_cast<bf16_t*>(s + 24576);      // MN-major A: 64 rows k x 64 m
  bf16_t* const bm = reinterpret_cast<bf16_t*>(s + 32768);      // MN-major B: 2 x (64 rows k x 64 n)
  const int t = threadIdx.x;
  auto av = [](int m, int k) { return (float)((m * 3 + k * 5) % 7 - 3); };
  auto bv = [](int k, int n) { return (float)((k * 2 + n * 7) % 5 - 2); };
  auto at = [](bf16_t* base, int row, int col) { return base + sw128(row, col) / 2; };
  const float tiny = 0.75f * 1.1920928955078125e-07f;  // 0.75 ulp of 1
  if (t == 0) out[2] = out[3] = out[4] = out[5] = 0.f;  // the errors' maxima, by atomicMax below
  for (int e = t; e < 64 * 64; e += 128) {  // the accumulation test's operands
    const int m = e / 64, k = e % 64;
    *at(ak, m, k) = __float2bfloat16_rn(k == 0 ? ((m & 15) < 8 ? tiny : -tiny) : 0.f);
  }
  for (int e = t; e < 128 * 64; e += 128) {
    const int n = e / 64, k = e % 64;
    *at(bk, n, k) = __float2bfloat16_rn(k == 0 ? 1.f : 0.f);
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  float d[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) d[r] = ((lane >> 2) + 8 * ((r >> 1) & 1)) < 8 ? 1.f : -1.f;
  fence_regs(d);
  wgmma_fence();
  mma_k16<128, 0, 0>(d, desc_b128(smem_u32(ak), 16, 1024), desc_b128(smem_u32(bk), 16, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  if (t == 0) {
    out[0] = d[0];  // row 0: 1 + 0.75 ulp
    out[1] = d[2];  // row 8: -(1 + 0.75 ulp)
  }
  __syncthreads();
  for (int e = t; e < 64 * 64; e += 128) {
    const int m = e / 64, k = e % 64;
    *at(ak, m, k) = __float2bfloat16_rn(av(m, k));
    *at(am, k, m) = __float2bfloat16_rn(av(m, k));
  }
  for (int e = t; e < 128 * 64; e += 128) {
    const int n = e / 64, k = e % 64;
    *at(bk, n, k) = __float2bfloat16_rn(bv(k, n));
    *at(bm + (n / 64) * 4096, k, n % 64) = __float2bfloat16_rn(bv(k, n));
  }
  __syncthreads();
  for (int layout = 0; layout < 2; ++layout) {
#pragma unroll
    for (int r = 0; r < 64; ++r) d[r] = 0.f;
    fence_regs(d);
    wgmma_fence();
    if (layout == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_k16<128, 0, 0>(d, desc_b128(smem_u32(ak) + 32 * kk, 16, 1024), desc_b128(smem_u32(bk) + 32 * kk, 16, 1024));
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_k16<128, 1, 1>(d, desc_b128(smem_u32(am) + 2048 * kk, 8192, 1024),
                           desc_b128(smem_u32(bm) + 2048 * kk, 8192, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    float err = 0.f;
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int m = 16 * warp + (lane >> 2) + 8 * ((r >> 1) & 1), n = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      float ref = 0.f;
      for (int k = 0; k < 64; ++k) ref = fmaf(av(m, k), bv(k, n), ref);
      err = fmaxf(err, fabsf(d[r] - ref));
    }
    atomicMax(reinterpret_cast<int*>(out + 2 + layout), __float_as_int(err));  // err >= 0: int order is float order
  }
  // (3) a K-major A that starts 3 rows into a 1024-byte-aligned tile of 128
  // rows (a conv tap's shifted window), with base offset 0 and with 3
  __syncthreads();
  bf16_t* const aw = reinterpret_cast<bf16_t*>(s + 24576);  // 128 rows m x 64 k, over the MN-major tiles
  for (int e = t; e < 128 * 64; e += 128) {
    const int m = e / 64, k = e % 64;
    *at(aw, m, k) = __float2bfloat16_rn(av(m, k));
  }
  __syncthreads();
  for (int base = 0; base < 2; ++base) {
#pragma unroll
    for (int r = 0; r < 64; ++r) d[r] = 0.f;
    fence_regs(d);
    wgmma_fence();
    const uint32_t start = smem_u32(aw) + 3 * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_k16<128, 0, 0>(d, desc_b128(start + 32 * kk, 16, 1024, base ? 3 : 0),
                         desc_b128(smem_u32(bk) + 32 * kk, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    float err = 0.f;
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int m = 16 * warp + (lane >> 2) + 8 * ((r >> 1) & 1), n = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      float ref = 0.f;
      for (int k = 0; k < 64; ++k) ref = fmaf(av(m + 3, k), bv(k, n), ref);
      err = fmaxf(err, fabsf(d[r] - ref));
    }
    atomicMax(reinterpret_cast<int*>(out + 4 + base), __float_as_int(err));
  }
}

int blocks_per_sm(int* blocks) {
  const void* tiles[7] = {(const void*)tile_kernel<1>, (const void*)tile_kernel<2>, (const void*)tile_kernel<3>,
                          (const void*)tile_kernel<4>, (const void*)tile_kernel<5>, (const void*)tile_kernel<6>,
                          (const void*)tile_kernel<7>};
  for (int i = 0; i < 7; ++i) blocks[i] = gated_hifi::blocks_per_sm(tiles[i], THREADS, TileSmem::BYTES);
  blocks[7] = gated_hifi::blocks_per_sm((const void*)gate16_kernel, GATE_THREADS, 0);
  blocks[8] = gated_hifi::blocks_per_sm((const void*)wgrad16_kernel, THREADS, RED_SMEM);
  blocks[9] = gated_hifi::blocks_per_sm((const void*)wgrad16_reduce_kernel, 256, 0);
  return (int)cudaGetLastError();
}

const bf16_t* cb16(const void* q) { return static_cast<const bf16_t*>(q); }
bf16_t* b16(void* q) { return static_cast<bf16_t*>(q); }

}  // namespace bwd16
}  // namespace gated_hifi

// The tile passes in bf16 (res_scale 1) on `stream`; returns a cudaError_t.
// Inputs: x, g [B, T, width], lens, the weights as gated_hifi_fwd_bf16 takes
// them, wg [W(in), W(out)] as stored, and the transposed w1_t [depth,
// H(out), H(in)], ks_t (the branches' [k_d, H(out), H(in)] back to back) and
// wall_t [depth*H, W]. Outputs: a, h1, dzp (the bf16 product copy), dc, dz
// [B, T, depth*H] bf16; u, gv, dx [B, T, width] bf16; zp [B, T, depth*H]
// and du [B, T, width] fp32 scratch (zp, then dzp; gv Wg^T); bias [B *
// ceil(T / 128), 3*depth*H + width] fp32, each 128-frame tile's column sums
// of dz | dc | dzp | gv.
extern "C" int gated_hifi_bwd_bf16(const void* x, const int* lens, const void* g, const void* wall, const void* ball,
                                   const void* ks, const void* cb, const void* w1, const void* b1, const void* wg,
                                   const void* w1_t, const void* ks_t, const void* wall_t, void* a, void* h1,
                                   float* zp, float* du, void* dzp, void* dc, void* dz, void* u, void* gv,
                                   float* bias, void* dx, int B, int T, int width, int depth, const int* kernels,
                                   const int* dilations, float scale, unsigned seed, unsigned threshold,
                                   float keep_scale, void* stream) {
  using namespace gated_hifi::bwd16;
  return backward(cb16(x), lens, cb16(g), cb16(wall), cb16(ball), cb16(ks), cb16(cb), cb16(w1), cb16(b1), cb16(wg),
                  cb16(w1_t), cb16(ks_t), cb16(wall_t), b16(a), b16(h1), zp, du, b16(dzp), b16(dc), b16(dz), b16(u),
                  b16(gv), bias, b16(dx), B, T, width, depth, kernels, dilations, scale, seed, threshold, keep_scale,
                  stream);
}

// Floats of the partials buffer gated_hifi_wgrad_bf16 needs at [B, T] and
// these branches, or -1 on an invalid branch table.
extern "C" long gated_hifi_wgrad_bf16_partial_floats(int B, int T, int depth, const int* kernels) {
  using namespace gated_hifi;
  std::vector<int> dil(depth > 0 ? depth : 1, 1);
  Branches br;
  if (!make_branches(depth, kernels, dil.data(), &br) || B < 1 || T < 1 || bwd16::sm_count() < 1) return -1;
  return bwd16::partial_floats(br, (long long)B * ((T + bwd16::RF - 1) / bwd16::RF));
}

// The weight gradients from the tile passes' bf16 buffers (x, a, h1, u the
// X operands; dzp, dc, dz, gv the Y operands) and their bias partials, into
// `grads` (bf16, the packed layout wall | ball | ks | cb | w1 | b1 | wg | bg
// of gated_hifi_fwd's weights), each summed in fp32 and rounded once.
// scale must be 1.
extern "C" int gated_hifi_wgrad_bf16(const void* x, const void* a, const void* h1, const void* dzp, const void* dc,
                                     const void* dz, const void* u, const void* gv, const float* bias,
                                     float* partials, void* grads, int B, int T, int width, int depth,
                                     const int* kernels, const int* dilations, float scale, void* stream) {
  using namespace gated_hifi::bwd16;
  return wgrad(cb16(x), cb16(a), cb16(h1), cb16(dzp), cb16(dc), cb16(dz), cb16(u), cb16(gv), bias, partials,
               b16(grads), B, T, width, depth, kernels, dilations, scale, stream);
}

// Resident blocks per SM of the bf16 backward's kernels (the seven tile
// stages, gate16_kernel, wgrad16_kernel, wgrad16_reduce_kernel) into
// blocks[0..9]; returns a cudaError_t.
extern "C" int gated_hifi_bwd_bf16_blocks_per_sm(int* blocks) { return gated_hifi::bwd16::blocks_per_sm(blocks); }

// wgmma's accumulation and layouts: out[0] = 1 + 0.75 ulp and out[1] =
// -(1 + 0.75 ulp) as wgmma sums them (1 + 2^-23 and -(1 + 2^-23) round to
// nearest; 1 and -1 truncate); out[2], out[3] the largest error of a K-major
// and an MN-major 64 x 128 x 64 product against FMA sums (0 when both
// layouts are read as written); out[4], out[5] the same for a K-major A
// from row 3 of its tile with base offset 0 and 3. out: 6 floats on the
// device.
extern "C" int wgmma_probe(float* out, void* stream) {
  gated_hifi::bwd16::wgmma_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return (int)cudaGetLastError();
}
