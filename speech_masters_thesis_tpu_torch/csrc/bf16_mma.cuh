// bf16 products on the tensor cores (mma.sync), for B2's bf16 kernels, B5's
// bf16 attention and the bf16 MMA probe (gated_hifi_fwd.cu); the bf16 dense
// products run on wgmma (hopper.cuh, bf16_engine.cuh). tf32_mma.cuh is the
// fp32 modes' 3xTF32 engine.
//
// Numerics. The TPU kernel's bf16 mode (ops/pallas/gated_hifi.py, dot_dtype
// = the input's dtype) rounds each product's operands to bf16 and
// accumulates in fp32 (preferred_element_type=f32); everything between the
// products stays fp32. A product of two bf16 values is exact in fp32 (8 x 8
// significant bits), so one mma.sync.m16n8k16 bf16 instruction computes what
// the TPU's MXU computes, up to the order of the fp32 sums: one MMA a product
// against 3xTF32's three, at 989 TFLOP/s dense on an H100 SXM against
// 495 / 3. Operands that live in fp32 (the backward's cotangents) are rounded
// to bf16 when a fragment is built (cvt.rn.bf16x2.f32: round to nearest
// even, as XLA's astype); operands stored in bf16 go in as they are.
// ops/gated_hifi.py's plain versions round at the same points.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, with
// g = lane / 4 and q = lane % 4 (PTX ISA, "Matrix fragments for mma.m16n8k16"),
// each register two bf16 values, the lower k in the low half:
//   A (16 x 16, row): a0 (g, 2q..2q+1), a1 (g + 8, 2q..2q+1),
//                     a2 (g, 2q+8..2q+9), a3 (g + 8, 2q+8..2q+9)
//   B (16 x 8, col):  b0 (k = 2q..2q+1, n = g), b1 (k = 2q+8..2q+9, n = g)
//   C (16 x 8):       c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
// So two adjacent n8 accumulator tiles, packed as (c0, c1), (c2, c3) of tile
// n and of tile n + 1, hold one k16 A fragment: the accumulator -> A operand
// reuse that tf32_mma.cuh gets from a permuted k-index.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16 {

// (lo, hi) -> bf16x2, lo in the low half, each rounded to nearest even
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// c += a * b on one m16n8k16 tile, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned); register i of lane (g, q) receives row
// g of matrix i at columns 2q and 2q + 1. From a [row][k] tile that is an A
// fragment (matrices: rows 0-7 and 8-15 at k 0-7, then at k 8-15) or, from a
// [n][k] tile, the B fragments of two k-steps.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// Four 8 x 8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8 (16 bytes, 16-byte aligned); register i of lane (g, q)
// receives rows 2q and 2q + 1 of matrix i at column g. From a [k][n] tile
// that is a B fragment; from a [k][m] tile (frames by channels) an A
// fragment of its transpose.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }

}  // namespace bf16
