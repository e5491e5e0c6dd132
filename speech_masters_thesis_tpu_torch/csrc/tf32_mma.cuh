// 3xTF32 products on the tensor cores and cp.async staging, shared by B1's
// kernels (gated_hifi_fwd.cu, gated_hifi_bwd.cu, through
// gated_hifi_tiles.cuh) and B2's forward and backward (attention_fwd.cu,
// attention_bwd.cu, through attention_common.cuh).
//
// Numerics. A TF32 operand keeps 10 explicit mantissa bits, so one TF32
// product is good to about 3 decimal digits, short of the fp32 tolerances
// the port holds its kernels to. Each fp32 operand is split as
// x = big(x) + small(x), big = cvt.rna.tf32.f32(x) and small =
// cvt.rna.tf32.f32(x - big), and a product is big*big + big*small +
// small*big (the small*small term, about 2^-22 of the product, is dropped),
// accumulated in fp32. That keeps about 21 bits of each product, close to
// fp32's 24, at 3 tensor-core MMAs per product: an fp32-accurate ceiling of
// 495/3 = 165 TFLOP/s on an H100 SXM against 67 TFLOP/s on the CUDA cores.
// ops/tf32.py emulates the split in torch; tests/test_torch_tf32_split.py
// holds it against fp64 at the kernels' shapes.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with
// g = lane / 4 and q = lane % 4 (PTX ISA, "Matrix fragments for mma.m16n8k8"):
//   A (16 x 8, row): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, col):  b0 (k = q, n = g), b1 (k = q + 4, n = g)
//   C (16 x 8):      c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
// An accumulator n-tile feeds the next product's A operand without a trip
// through shared memory when the k-step's index is permuted: logical k = q
// is column 2q and k = q + 4 is column 2q + 1, so (a0, a1, a2, a3) =
// (c0, c2, c1, c3), and the B operand's rows are read in the same order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

struct Split {
  uint32_t big, small;
};

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, on the low 13
// mantissa bits) in two integer operations: half a TF32 ulp added to the
// magnitude, then the low bits cleared. The same bits as the cvt for every
// finite input, at the integer pipes' rate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

// c += a * b on one m16n8k8 tile, TF32 operands, fp32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A and B fragments of one k-step, split
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  const float v[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.big[i] = s.big;
    f.small[i] = s.small;
  }
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.big, s1.big}, {s0.small, s1.small}};
}

// c += a * b in 3xTF32: the small terms first, then big * big
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.small, b.big);
  mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// ---- cp.async: copies from device to shared memory ----------------------
// src_bytes 0 writes 16 zero bytes and reads nothing (src must still be a
// valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}

// 4-byte copy (.ca: .cg takes 16-byte copies only)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Four floats into shared memory at dst in 4-byte copies: at(e) is the
// address of float e, or null for a zero. For rows whose width, stride or
// offset is not a multiple of 4 floats, which a 16-byte copy needs.
template <class At>
__device__ __forceinline__ void stage4(float* dst, At at) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float* q = at(e);
    if (q)
      cp_async4(dst + e, q);
    else
      dst[e] = 0.f;
  }
}

__host__ __device__ inline bool aligned16(const void* p) { return !(reinterpret_cast<uintptr_t>(p) & 15); }

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32
