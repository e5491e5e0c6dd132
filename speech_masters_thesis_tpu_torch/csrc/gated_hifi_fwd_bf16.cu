// GatedHiFi block forward in bf16 for Hopper (sm_90a), every product on
// wgmma with its operands staged by TMA (hopper.cuh). The fp32 forward
// stays in gated_hifi_fwd.cu.
//
// Replaces: speech_masters_thesis_tpu/ops/pallas/gated_hifi.py, function
// fused_gated_hifi -> _fwd -> _fwd_kernel in its bf16 mode (dot_dtype =
// bf16), with its dropout (_branch_masks). Its rounding points: x, Wall,
// K_d, W1_d and Wg bf16 operands with fp32 sums; zp = z + h in fp32; the
// gate in fp32; u rounded to bf16 for u Wg; the residual in fp32; the
// output masked to min(T, len) and stored in bf16. res_scale 1 only.
//
// What it computes, per sequence b and frame t (x pre-masked, H = 2W):
//   a_d  = relu(x Wall_d + ball_d) * m0_d              1 expand
//   h1_d = relu(sum_j a_d[t + (j-half) dil] K_d[j] + cb_d) * m1_d   2 conv
//   zp_d = h1_d W1_d + b1_d + x Wall_d + ball_d
//   u    = sum_d tanh(zp_d[:, :W]) * softmax_d(zp_d[:, W:])
//   out  = (x + u Wg + bg) * [t < min(T, lens[b])]     3 gate (zp, u, out)
// The dropout masks m0_d, m1_d are gated_hifi_common.cuh's hash, so they
// equal the plain version's and the backward's bit for bit.
//
// What bounds it on an H100: at W = 64 and kernels (3, 5, 7, 9) a frame
// costs about 1.06 MFLOP, the dilated convs 74% of it: 1.12 ms at 989 TF/s
// over the VQ-VAE's 7 block shapes (16 x 65,532 frames). The stages meet in
// a and h1 (bf16 [B, T, depth*H], 1 KB a frame each), so the design moves
// about 4.5 KB a frame (x read by stages 1 and 3, a written and read, h1
// written and read, out written): 1.4 ms at 3.35 TB/s there.
//
// Design. One launch first transposes Wall, the conv kernels and W1 into
// the scratch buffer (wgmma reads them K-major). Stage 1 is the bf16
// backward's tile pass 1 (gated_hifi_bwd_bf16.cu, launch_tiles<1>), which
// computes the same a with the same masks. Stage 2 (branch_conv_kernel)
// adds each k-slice's products into fp32 sums, as the backward's conv
// recompute does not (see there). Stage 3 (branch_gate_kernel): one item is a
// 64-frame tile of one sequence over every branch, so zp never leaves the
// chip. For each branch d the item's 128 zp columns are one m64n128 wgmma
// product over three k-slices (h1_d's two 64-channel halves against W1_d, x
// against Wall_d), staged by TMA into a ring. Its epilogue runs in
// registers: each thread holds zp's t half and s half of the same (frame,
// channel) (columns c and c + 64 of the accumulator) and keeps the gate's
// running max, sum of exp(s - max) and sum of tanh(t) exp(s - max) over the
// branches, one exp a branch and no divergent branch (a divergent one cost
// the stage a third of its time). After the last branch, u = sum / weight
// goes to shared memory in bf16 (a K-major wgmma operand), one m64n64
// product with the resident Wg gives u Wg, and the epilogue adds x and bg
// and stores the masked output. A persistent block walks a contiguous run
// of items; its two warpgroups take alternate items, each feeding a ring of
// its own by TMA, so one's gate arithmetic runs beside the other's
// products. The products' fp32 accumulation truncates (wgmma_probe); a
// branch sums 192 terms a column.

#include "gated_hifi_bf16.cuh"

namespace gated_hifi {
namespace fwd_bf16 {

using namespace hopper;
using bwd16::KC;

// two warpgroups, each loading its own ring and multiplying what lands in
// it: at 256 threads a thread may hold 255 registers, which the
// accumulators and the gate's running state need (with producer warps
// beside them, 320 or 384 threads, ptxas holds the kernel to 168 and the
// state spills)
constexpr int THREADS = 256;
constexpr int TF = 64;                            // frames an item of the gate stage
constexpr int RING = 4;                           // slots a consumer's ring holds
constexpr int A_BYTES = TF * KC * 2;              // an activation slice: 64 frames x 64 channels
constexpr int B_BYTES = H * KC * 2;               // a weight slice: 128 rows (n) x 64 (k)
constexpr int SLOT = A_BYTES + B_BYTES;
constexpr int WG_OFF = 2 * RING * SLOT;           // Wg: 64 rows (k) x 64 (n), MN-major B
constexpr int U_OFF = WG_OFF + W * W * 2;         // each consumer's u tile: 64 frames x 64 (k), K-major A
constexpr int BIAS_OFF = U_OFF + 2 * TF * W * 2;  // fp32 b1 + ball [MAX_DEPTH][H], then bg [W]
constexpr int BAR_OFF = BIAS_OFF + (MAX_DEPTH * H + W) * 4;
constexpr int SMEM = BAR_OFF + (2 * RING + 1) * 8 + 1024;  // + the 1024-byte alignment of the dynamic buffer
static_assert(SLOT % 1024 == 0 && WG_OFF % 1024 == 0 && U_OFF % 1024 == 0, "swizzled tiles are 1024-aligned");
static_assert(SMEM <= 232448, "gate stage: shared memory over the block limit");

struct Params {
  CUtensorMap m_x, m_h1;         // [B, T, C] activations in boxes of 64 channels x 64 frames
  CUtensorMap m_w1_t, m_wall_t;  // K-major weight slices: 64 columns (k) x 128 rows (n)
  CUtensorMap m_wg;              // Wg [W(in), W(out)] as stored, one 64 x 64 box
  const bf16_t *x, *ball, *b1, *bg;
  const int* lens;
  bf16_t* out;
  int B, T, ntf, depth;
};

struct ConvParams {
  CUtensorMap m_a, m_h1;  // a (loads) and h1 (stores) [B, T, depth*H] in boxes of 64 channels x 64 frames
  CUtensorMap m_ks_t;     // K-major tap slices: 64 columns (k) x 128 rows (n)
  const bf16_t* cb;
  int B, T, ntf;
  Branches br;
  Dropout drop;
};

constexpr int OUT_OFF = 2 * RING * SLOT;              // each warpgroup's h1 tile: two 64 x 64 swizzled halves
constexpr int CONV_BAR_OFF = OUT_OFF + 2 * TF * H * 2;
constexpr int CONV_SMEM = CONV_BAR_OFF + 2 * RING * 8 + 1024;
static_assert(CONV_SMEM <= 232448, "conv stage: shared memory over the block limit");

// 2. h1_d = relu(sum_j a_d[t + (j-half) dil] K_d[j] + cb_d) * m1_d over
// (64-frame tile, sequence, branch) items. A block takes a run of the
// branch-major items whose k-slices (2 k_d an item: a tap's two 64-channel
// halves) are its share of all; its warpgroups take alternate items, each
// lead thread keeping RING of its slices in flight as in the gate stage.
// Each k-slice's 4 wgmmas start from zero and are added to fp32 sums: the
// accumulation truncates (wgmma_probe), and over an item's 2 k_d slices
// unflushed (72 k16 steps at k = 9) it biased h1 enough that the VQ-VAE's
// log-magnitude STFT loss took it into the bf16 step's gradients (phase
// 37). h1 leaves through a swizzled tile in shared memory by TMA stores,
// which drop the rows past T.
__global__ void __launch_bounds__(THREADS, 1) branch_conv_kernel(const __grid_constant__ ConvParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = bwd16::align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + CONV_BAR_OFF);  // [warpgroup][slot]
  const int depth = p.br.depth, n_per = p.B * p.ntf;
  // the block's items: branch d's l in [l0[d], l1[d]), by the slices' cost
  int l0[MAX_DEPTH], l1[MAX_DEPTH], n_items = 0;
  {
    long long total = 0;
    for (int d = 0; d < depth; ++d) total += (long long)n_per * 2 * p.br.k[d];
    const long long lo = total * blockIdx.x / gridDim.x, hi = total * (blockIdx.x + 1) / gridDim.x;
    long long cum = 0;
    for (int d = 0; d < depth; ++d) {
      const int ns = 2 * p.br.k[d];
      auto first = [&](long long at) {
        const long long l = at > cum ? (at - cum + ns - 1) / ns : 0;
        return l > n_per ? n_per : (int)l;
      };
      l0[d] = first(lo);
      l1[d] = first(hi);
      n_items += l1[d] - l0[d];
      cum += (long long)n_per * ns;
    }
  }
  auto item = [&](int n, int& d, int& l) {  // the block's n-th item
    d = 0;
    while (n >= l1[d] - l0[d]) n -= l1[d] - l0[d], ++d;
    l = l0[d] + n;
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * RING; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int c = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool lead = (threadIdx.x & 127) == 0;
  // the lead's loader: slice ls of the block's item ln, the warpgroup's lq-th slice
  int ln = c, ls = 0;
  long long lq = 0;
  auto load = [&]() {
    if (ln >= n_items) return;
    int d, l;
    item(ln, d, l);
    const int b = l / p.ntf, t0 = (l % p.ntf) * TF, j = ls >> 1, h = ls & 1;
    const int shift = (j - (p.br.k[d] - 1) / 2) * p.br.dil[d];
    uint64_t* const f = &full[c * RING + (int)(lq % RING)];
    uint8_t* const st = sm + (c * RING + (int)(lq % RING)) * SLOT;
    mbar_expect_tx(f, SLOT);
    tma_load_3d(st, &p.m_a, f, d * H + KC * h, t0 + shift, b);
    tma_load_2d(st + A_BYTES, &p.m_ks_t, f, KC * h, p.br.k_off[d] / H + j * H);
    ++lq;
    if (++ls == 2 * p.br.k[d]) ls = 0, ln += 2;
  };
  if (lead)
    for (int q = 0; q < RING; ++q) load();
  uint8_t* const ot = sm + OUT_OFF + c * (TF * H * 2);
  // accumulator r of this thread: frame row0 + 8 ((r / 2) % 2), column 8 (r / 4) + col0 + r % 2
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  long long q = 0;  // this warpgroup's slices consumed
  for (int n = c; n < n_items; n += 2) {
    int d, l;
    item(n, d, l);
    const int b = l / p.ntf, t0 = (l % p.ntf) * TF;
    float sum[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) sum[r] = 0.f;
    for (int s = 0; s < 2 * p.br.k[d]; ++s, ++q) {
      float acc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = 0.f;
      fence_regs(acc);
      const int slot = (int)(q % RING);
      mbar_wait(&full[c * RING + slot], (uint32_t)(q / RING) & 1u);
      const uint32_t a_addr = smem_u32(sm + (c * RING + slot) * SLOT), b_addr = a_addr + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        mma_k16<H, 0, 0>(acc, desc_b128(a_addr + 32 * kk, 16, 1024), desc_b128(b_addr + 32 * kk, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lead) load();
#pragma unroll
      for (int r = 0; r < 64; ++r) sum[r] += acc[r];
    }
    // the tile is free once the last item's stores have read it
    if (lead) bulk_wait_read();
    named_sync(1 + c, 128);
    const uint32_t key = p.drop.threshold ? dropout_key(p.drop.seed, b, d) : 0u;
#pragma unroll
    for (int r = 0; r < 64; r += 2) {
      const int row = row0 + 8 * ((r >> 1) & 1), col = 8 * (r >> 2) + col0, t = t0 + row;
      float v0 = fmaxf(sum[r] + f32(p.cb[d * H + col]), 0.f), v1 = fmaxf(sum[r + 1] + f32(p.cb[d * H + col + 1]), 0.f);
      if (p.drop.threshold) {
        v0 *= site_keep(dropout_bits(key, t, col), false, p.drop);
        v1 *= site_keep(dropout_bits(key, t, col + 1), false, p.drop);
      }
      *reinterpret_cast<__nv_bfloat162*>(ot + (col / W) * (TF * W * 2) + sw128(row, col % W)) =
          __floats2bfloat162_rn(v0, v1);
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    if (lead) {
      tma_store_3d(&p.m_h1, ot, d * H, t0, b);
      tma_store_3d(&p.m_h1, ot + TF * W * 2, d * H + W, t0, b);
      bulk_commit();
    }
  }
  if (lead) bulk_wait();
}

// 3. zp, the gate, u Wg and the residual over (64-frame tile, sequence) items
__global__ void __launch_bounds__(THREADS, 1) branch_gate_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = bwd16::align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);  // [warpgroup][slot]
  uint64_t* const wg_bar = full + 2 * RING;
  float* const bsum = reinterpret_cast<float*>(sm + BIAS_OFF);  // [d][H]: b1_d + ball_d
  float* const bgs = bsum + MAX_DEPTH * H;
  const int depth = p.depth, ns = 3 * depth;  // k-slices an item
  const long long items = (long long)p.B * p.ntf;
  const long long i0 = items * blockIdx.x / gridDim.x, i1 = items * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * RING; ++i) mbar_init(&full[i], 1);
    mbar_init(wg_bar, 1);
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < depth * H; i += THREADS) bsum[i] = f32(p.b1[i]) + f32(p.ball[i]);
  for (int i = threadIdx.x; i < W; i += THREADS) bgs[i] = f32(p.bg[i]);
  __syncthreads();

  // the block's n-th item goes to warpgroup c = n % 2; its lead thread keeps
  // RING of its k-slices in flight: slice q (item q / ns of c's, branch
  // (q % ns) / 3, s = q % 3: h1_d's channels 0-63 and 64-127 against W1_d,
  // x against Wall_d) into slot q % RING once the products that read the
  // slot's last slice are done
  const int c = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool lead = (threadIdx.x & 127) == 0;
  const long long n_slices = (i1 - i0 - c + 1) / 2 * ns;
  auto load = [&](long long q) {
    if (q >= n_slices) return;
    const long long i = i0 + c + 2 * (q / ns);
    const int b = (int)(i / p.ntf), t0 = (int)(i % p.ntf) * TF, k = (int)(q % ns), d = k / 3, s = k % 3;
    uint64_t* const f = &full[c * RING + (int)(q % RING)];
    uint8_t* const st = sm + (c * RING + (int)(q % RING)) * SLOT;
    mbar_expect_tx(f, SLOT);
    if (s < 2) {
      tma_load_3d(st, &p.m_h1, f, d * H + KC * s, t0, b);
      tma_load_2d(st + A_BYTES, &p.m_w1_t, f, KC * s, d * H);
    } else {
      tma_load_3d(st, &p.m_x, f, 0, t0, b);
      tma_load_2d(st + A_BYTES, &p.m_wall_t, f, 0, d * H);
    }
  };
  if (lead) {
    if (c == 0) {
      mbar_expect_tx(wg_bar, W * W * 2);
      tma_load_2d(sm + WG_OFF, &p.m_wg, wg_bar, 0, 0);
    }
    for (int q = 0; q < RING; ++q) load(q);
  }
  uint8_t* const us = sm + U_OFF + c * (TF * W * 2);
  const uint32_t u_addr = smem_u32(us), wg_addr = smem_u32(sm + WG_OFF);
  // accumulator r of this thread: frame row0 + 8 ((r / 2) % 2), column 8 (r / 4) + col0 + r % 2
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
  mbar_wait(wg_bar, 0);
  long long q = 0;  // this warpgroup's slices consumed
  for (long long i = i0 + c; i < i1; i += 2) {
    const int b = (int)(i / p.ntf), t0 = (int)(i % p.ntf) * TF;
    // the gate over the branches at this thread's 32 (frame, t-channel) pairs: running max of s,
    // sum of exp(s - max), sum of tanh(t) exp(s - max)
    float mx[32], den[32], num[32];
    for (int d = 0; d < depth; ++d) {
      float acc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] = 0.f;
      // one slice's products stay in flight while the next slice's are
      // issued; a slot is refilled once the products that read it are done
      fence_regs(acc);
      for (int s = 0; s < 3; ++s, ++q) {
        const int slot = (int)(q % RING);
        mbar_wait(&full[c * RING + slot], (uint32_t)(q / RING) & 1u);
        const uint8_t* st = sm + (c * RING + slot) * SLOT;
        const uint32_t a_addr = smem_u32(st), b_addr = smem_u32(st + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          mma_k16<H, 0, 0>(acc, desc_b128(a_addr + 32 * kk, 16, 1024), desc_b128(b_addr + 32 * kk, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();
        if (lead && s > 0) load(q - 1 + RING);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lead) load(q - 1 + RING);
      const float* bs = bsum + d * H;
#pragma unroll
      for (int r = 0; r < 32; ++r) {  // columns < W: the t half; r + 32 holds the s half of the same pair
        const int col = 8 * (r >> 2) + col0 + (r & 1);
        const float zt = acc[r] + bs[col], zs = acc[r + 32] + bs[col + W];
        const float th = tanhf(zt);
        if (d == 0) {
          mx[r] = zs;
          den[r] = 1.f;
          num[r] = th;
        } else {  // exp(-|zs - max|) rescales the sums (a new max) or weighs this branch
          const bool up = zs > mx[r];
          const float e = expf(-fabsf(zs - mx[r]));
          den[r] = up ? fmaf(den[r], e, 1.f) : den[r] + e;
          num[r] = up ? fmaf(num[r], e, th) : fmaf(th, e, num[r]);
          mx[r] = up ? zs : mx[r];
        }
      }
    }
    // u, rounded to bf16 (the TPU kernel's u.astype(dot_dtype)), into this consumer's u tile
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int row = row0 + 8 * ((r >> 1) & 1), col = 8 * (r >> 2) + col0;
      *reinterpret_cast<__nv_bfloat162*>(us + sw128(row, col)) =
          __floats2bfloat162_rn(num[r] / den[r], num[r + 1] / den[r + 1]);
    }
    fence_proxy_async();
    named_sync(1 + c, 128);
    float o[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) o[r] = 0.f;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      mma_k16<W, 0, 1>(o, desc_b128(u_addr + 32 * kk, 16, 1024), desc_b128(wg_addr + 2048 * kk, 8192, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    const int len = min(p.T, p.lens[b]);
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int row = row0 + 8 * ((r >> 1) & 1), col = 8 * (r >> 2) + col0;
      const int t = t0 + row;
      if (t >= p.T) continue;
      const size_t at = ((size_t)b * p.T + t) * W + col;
      float2 v = make_float2(0.f, 0.f);
      if (t < len) {
        const float2 xv = ld2(p.x + at);
        v = make_float2(xv.x + (o[r] + bgs[col]), xv.y + (o[r + 1] + bgs[col + 1]));
      }
      st2(p.out + at, v.x, v.y);
    }
  }
}

cudaError_t launch_conv(const ConvParams& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(branch_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CONV_SMEM);
  if (err != cudaSuccess) return err;
  const long long items = (long long)p.br.depth * p.B * p.ntf;
  const int grid = (int)(items < bwd16::sm_count() ? items : bwd16::sm_count());
  branch_conv_kernel<<<grid, THREADS, CONV_SMEM, s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_gate(const Params& p, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(branch_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const long long items = (long long)p.B * p.ntf;
  const int grid = (int)(items < bwd16::sm_count() ? items : bwd16::sm_count());
  branch_gate_kernel<<<grid, THREADS, SMEM, s>>>(p);
  return cudaGetLastError();
}

// The weights the stages read K-major, transposed from their stored layouts
// in one launch (in the wrapper they cost five PyTorch ops and their host
// time): wall_t [depth*H, W] from Wall [W, depth*H], ks_t (branch d's taps
// j at rows k_off[d] / H + j*H: [H(out), H(in)]) from K_d [k_d, H(in),
// H(out)], w1_t [depth*H(out), H(in)] from W1 [depth, H(in), H(out)].
struct Pack {
  const bf16_t* wall;
  const bf16_t* ks[MAX_DEPTH];
  const bf16_t* w1;
  bf16_t *wall_t, *ks_t, *w1_t;
  int n_wall, n_ks, n_w1;
  Branches br;
};

__global__ void __launch_bounds__(256) transpose_weights_kernel(const __grid_constant__ Pack a) {
  const int ldw = a.br.depth * H;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n_wall + a.n_ks + a.n_w1; i += gridDim.x * blockDim.x) {
    if (i < a.n_wall) {
      a.wall_t[i] = a.wall[(i % W) * ldw + i / W];
    } else if (i < a.n_wall + a.n_ks) {
      const int e = i - a.n_wall, row = e / H, in = e % H;
      int d = 0;
      while (d + 1 < a.br.depth && a.br.k_off[d + 1] / H <= row) ++d;
      const int j = (row - a.br.k_off[d] / H) / H, out = (row - a.br.k_off[d] / H) % H;
      a.ks_t[e] = a.ks[d][((size_t)j * H + in) * H + out];
    } else {
      const int e = i - a.n_wall - a.n_ks, row = e / H, in = e % H;
      a.w1_t[e] = a.w1[((size_t)(row / H) * H + in) * H + row % H];
    }
  }
}

int forward(const bf16_t* x, const int* lens, const bf16_t* wall, const bf16_t* ball, const bf16_t* const* ks,
            const bf16_t* cb, const bf16_t* w1, const bf16_t* b1, const bf16_t* wg, const bf16_t* bg,
            bf16_t* scratch, bf16_t* out, int B, int T, int width, int depth, const int* kernels,
            const int* dilations, float scale, unsigned seed, unsigned threshold, float keep_scale, void* stream) {
  bwd16::TileParams tp{};
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (width != W || B < 1 || T < 1 || scale != 1.f || !make_branches(depth, kernels, dilations, &tp.br) ||
      bwd16::sm_count() < 1 || !aligned(ball) || !aligned(cb) || !aligned(scratch))
    return (int)cudaErrorInvalidValue;
  const int ldw = depth * H, taps_rows = tp.br.k_off[depth - 1] / H + tp.br.k[depth - 1] * H;
  Pack pk{};
  pk.wall = wall;
  for (int d = 0; d < depth; ++d) pk.ks[d] = ks[d];
  pk.w1 = w1;
  pk.br = tp.br;
  pk.n_wall = ldw * W;
  pk.n_ks = taps_rows * H;
  pk.n_w1 = ldw * H;
  bf16_t* const a = scratch;
  bf16_t* const h1 = a + (size_t)B * T * ldw;
  pk.wall_t = h1 + (size_t)B * T * ldw;
  pk.ks_t = pk.wall_t + pk.n_wall;
  pk.w1_t = pk.ks_t + pk.n_ks;
  ConvParams cp{};
  Params p{};
  const bool ok = bwd16::act_map(&tp.m_x, x, B, T, W, bwd16::TM) &&
                  bwd16::weight_map(&tp.m_wall_t, pk.wall_t, ldw, W, 128) &&
                  bwd16::act_map(&cp.m_a, a, B, T, ldw, TF) && bwd16::act_map(&cp.m_h1, h1, B, T, ldw, TF) &&
                  bwd16::weight_map(&cp.m_ks_t, pk.ks_t, taps_rows, H, 128) &&
                  bwd16::act_map(&p.m_x, x, B, T, W, TF) && bwd16::weight_map(&p.m_w1_t, pk.w1_t, ldw, H, 128) &&
                  bwd16::weight_map(&p.m_wg, wg, W, W, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  p.m_h1 = cp.m_h1;
  p.m_wall_t = tp.m_wall_t;
  tp.ball = ball;
  tp.lens = lens;
  tp.a = a;
  tp.B = B;
  tp.T = T;
  tp.ntt = (T + bwd16::TM - 1) / bwd16::TM;
  tp.keep = threshold ? keep_scale : 1.f;
  tp.drop = Dropout{seed, threshold, keep_scale};
  cp.cb = cb;
  cp.B = B;
  cp.T = T;
  cp.ntf = (T + TF - 1) / TF;
  cp.br = tp.br;
  cp.drop = tp.drop;
  p.x = x;
  p.ball = ball;
  p.b1 = b1;
  p.bg = bg;
  p.lens = lens;
  p.out = out;
  p.B = B;
  p.T = T;
  p.ntf = (T + TF - 1) / TF;
  p.depth = depth;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // in stream order: each stage reads what the ones before it wrote
  transpose_weights_kernel<<<bwd16::sm_count(), 256, 0, s>>>(pk);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = bwd16::launch_tiles<1>(tp, s);
  if (err == cudaSuccess) err = launch_conv(cp, s);
  if (err == cudaSuccess) err = launch_gate(p, s);
  return (int)err;
}

const bf16_t* cb16(const void* q) { return static_cast<const bf16_t*>(q); }
bf16_t* b16(void* q) { return static_cast<bf16_t*>(q); }

}  // namespace fwd_bf16
}  // namespace gated_hifi

// The bf16 forward (res_scale 1) on `stream`: the weights packed K-major,
// stage 1 (expand) of the bf16 backward's tile passes, then the conv and
// gate stages; returns a cudaError_t. All tensors are contiguous bf16 on
// the device (lens int32): x/out [B, T, width], the weights as
// gated_hifi_fwd takes them but for ks, a host array of the `depth`
// branches' [k_d, H, H] kernels; scratch, 16-byte aligned, holds a and h1
// [B, T, depth*H], then wall_t [depth*H, width], the taps' [H, H]
// transposed and w1_t [depth*H, H]: 2 B T depth H + depth H width + (sum
// k_d) H^2 + depth H^2 elements. Dropout keeps an element when its 16-bit
// field is >= threshold and scales it by keep_scale; threshold 0 is p = 0.
extern "C" int gated_hifi_fwd_bf16(const void* x, const int* lens, const void* wall, const void* ball,
                                   const void* const* ks, const void* cb, const void* w1, const void* b1,
                                   const void* wg, const void* bg, void* scratch, void* out, int B, int T,
                                   int width, int depth, const int* kernels, const int* dilations, float scale,
                                   unsigned seed, unsigned threshold, float keep_scale, void* stream) {
  using namespace gated_hifi::fwd_bf16;
  return forward(cb16(x), lens, cb16(wall), cb16(ball), reinterpret_cast<const gated_hifi::bf16_t* const*>(ks), cb16(cb),
                 cb16(w1), cb16(b1), cb16(wg), cb16(bg), b16(scratch), b16(out), B, T, width, depth, kernels,
                 dilations, scale, seed, threshold, keep_scale, stream);
}

// Resident blocks per SM of the bf16 forward's stages, in launch order
// (tile_kernel<1>, branch_conv_kernel, branch_gate_kernel), into
// blocks[0..2]; returns a cudaError_t.
extern "C" int gated_hifi_fwd_bf16_blocks_per_sm(int* blocks) {
  using namespace gated_hifi;
  int tiles[10];
  const int rc = bwd16::blocks_per_sm(tiles);
  blocks[0] = tiles[0];
  blocks[1] = blocks_per_sm((const void*)fwd_bf16::branch_conv_kernel, fwd_bf16::THREADS, fwd_bf16::CONV_SMEM);
  blocks[2] = blocks_per_sm((const void*)fwd_bf16::branch_gate_kernel, fwd_bf16::THREADS, fwd_bf16::SMEM);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
