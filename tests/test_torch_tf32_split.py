"""The 3xTF32 split that B1's and B2's backward kernels run on the tensor
cores (csrc/tf32_mma.cuh), emulated on the CPU by ops/tf32.py: why the
kernels meet chip_smoke.py's fp32 tolerances unchanged, and why a single
TF32 product would not."""

import numpy as np
import pytest
import torch

from chip_smoke import ATTN_GRAD_RTOL, DX_RTOL
from speech_masters_thesis_tpu_torch.ops import tf32


def _bits(x: torch.Tensor) -> list:
    return [v & 0xFFFFFFFF for v in x.view(torch.int32).tolist()]


def _floats(bits) -> torch.Tensor:
    return torch.tensor([b - 2 ** 32 if b >= 2 ** 31 else b for b in bits], dtype=torch.int32).view(torch.float32)


def test_round_tf32_matches_hand_checked_bits():
    # (input bits, cvt.rna.tf32.f32 bits): the low 13 bits round to nearest,
    # ties away from zero, and a carry moves into the exponent
    cases = [
        (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
        (0x3F800FFF, 0x3F800000),  # below half an ulp: down
        (0x3F801000, 0x3F802000),  # a tie: away from zero
        (0xBF801000, 0xBF802000),  # a negative tie: away from zero too
        (0x3F801FFF, 0x3F802000),  # above half: up
        (0x3FFFF000, 0x40000000),  # the carry reaches the exponent: 2.0
        (0x7F7FFFFF, 0x7F800000),  # past the largest TF32 value: inf
        (0x00000000, 0x00000000),
    ]
    got = _bits(tf32.round_tf32(_floats([c for c, _ in cases])))
    assert [hex(g) for g in got] == [hex(e) for _, e in cases]


def test_split_keeps_22_bits():
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096)).astype(np.float32))
    big, small = tf32.split(x)
    assert all(b & 0x1FFF == 0 for b in _bits(big) + _bits(small))
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21


def _operands(case: str, rng):
    """Seeded operands at the kernels' shapes and scales, with the tolerance
    chip_smoke.py holds that product's gradient to."""
    if case == "b1_conv_tap":  # a [64 frames x 128] relu activation tile by one [128 x 128] tap
        a = np.maximum(rng.randn(64, 128), 0.0)
        b = rng.randn(128, 128) / np.sqrt(128)
        tol = DX_RTOL
    elif case == "b2_qk":  # S = Q K^T over D = 32 for a 64 x 64 tile
        a, b = rng.randn(64, 32), rng.randn(32, 64)
        tol = ATTN_GRAD_RTOL
    else:  # dQ = dS K: a 64 x 64 tile of dS by 64 keys of D = 32
        a, b = rng.randn(64, 64) * 0.01, rng.randn(64, 32)
        tol = ATTN_GRAD_RTOL
    return torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32)), tol


@pytest.mark.parametrize("case", ["b1_conv_tap", "b2_qk", "b2_ds_k"])
def test_three_products_meet_the_fp32_tolerance_and_one_does_not(case):
    a, b, tol = _operands(case, np.random.RandomState(1))
    ref = a.double() @ b.double()
    scale = ref.abs().max().item()
    err3 = (tf32.matmul(a, b, passes=3).double() - ref).abs().max().item() / scale
    err1 = (tf32.matmul(a, b, passes=1).double() - ref).abs().max().item() / scale
    err32 = ((a @ b).double() - ref).abs().max().item() / scale
    assert err3 <= tol / 50, (case, err3, tol)      # well inside: the tolerance needed no change
    assert err3 <= 4 * max(err32, 2.0 ** -24)       # and about fp32's own rounding
    assert err1 > tol, (case, err1, tol)            # a single TF32 product would miss it
