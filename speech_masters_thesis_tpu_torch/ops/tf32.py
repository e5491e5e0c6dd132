"""The 3xTF32 split of ``csrc/tf32_mma.cuh``, emulated in torch.

B1's forward and backward kernels (``csrc/gated_hifi_{fwd,bwd}.cu``, their
weight-gradient reduction included) and B2's backward
(``csrc/attention_bwd.cu``) run their products on the tensor cores with
TF32 operands. A TF32 operand keeps 10 explicit mantissa bits, so each fp32
operand is split as ``x = big + small`` (both TF32), and a product is
``small_a big_b + big_a small_b + big_a big_b`` accumulated in fp32, one
8-deep MMA k-step at a time. This module computes the same numbers on the
CPU, so the tests can show why the kernels meet the fp32 tolerances that a
single TF32 product misses. Nothing on the model paths uses it.
"""

from __future__ import annotations

import torch

KSTEP = 8  # the k depth of one mma.m16n8k8 TF32 step


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to nearest, ties away from zero, on the
    low 13 mantissa bits of each float32 (the kernels' ``tf32::to_tf32``:
    half a TF32 ulp added to the magnitude, then the low bits cleared)."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return torch.where(rounded >= 2 ** 31, rounded - 2 ** 32, rounded).to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    """(big, small): x = big + small up to the dropped low bits, both TF32."""
    big = round_tf32(x)
    return big, round_tf32(x.to(torch.float32) - big)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 next to it on the side of zero."""
    f = x.to(torch.float32)
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3, acc: torch.Tensor | None = None,
           rz_steps: int | None = None) -> torch.Tensor:
    """acc + a [M, K] @ b [K, N] as the kernels compute it: K in steps of 8,
    each step's products of TF32 operands summed exactly (float64), for
    passes = 3 in the kernels' order (small big, big small, big big);
    passes = 1 is a single TF32 product (big big). ``acc`` (zeros if None)
    is the float32 accumulator a product goes on accumulating into.

    ``rz_steps`` None adds each MMA's sum to acc rounding to nearest.
    Otherwise it models the tensor cores' accumulation, which truncates:
    each MMA's sum is rounded toward zero in a register that starts from
    zero and is added to acc (rounding to nearest) every ``rz_steps``
    k-steps, or only at the end for 0: B1's forward stages
    (``gated_hifi_tiles.cuh:mma_tile`` with RN) are 1, its weight-gradient
    reduction 128, ``tf32_mma.cuh:mma3`` into one accumulator 0."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    terms = [(a_big, b_big)] if passes == 1 else [(a_small, b_big), (a_big, b_small), (a_big, b_big)]
    # float64 once: the conversion is exact, and so is each step's product
    terms = [(x.double(), y.double()) for x, y in terms]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32) if acc is None else acc.to(torch.float32)
    part = torch.zeros_like(acc)  # the tensor cores' register, for rz_steps
    n_steps = -(-a.shape[1] // KSTEP)
    for i, k0 in enumerate(range(0, a.shape[1], KSTEP)):
        for x, y in terms:
            step = x[:, k0:k0 + KSTEP] @ y[k0:k0 + KSTEP]
            if rz_steps is None:
                acc = (acc.double() + step).to(torch.float32)
            else:
                part = _round_toward_zero(part.double() + step)
        if rz_steps is not None and (i + 1 == n_steps or (rz_steps and (i + 1) % rz_steps == 0)):
            acc = acc + part
            part = torch.zeros_like(acc)
    return acc
