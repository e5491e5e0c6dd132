"""The 3xTF32 split that B1's kernels (forward, backward tile passes and
weight-gradient reduction) and B2's backward run on the tensor cores
(csrc/tf32_mma.cuh), emulated on the CPU by ops/tf32.py: why the kernels
meet chip_smoke.py's fp32 tolerances unchanged, and why a single TF32
product would not.

* The rounding's bits, and 3 vs 1 TF32 products against fp64 at a B1 conv
  tap and two B2 tiles.
* B1's forward as its kernel computes it: the stage decomposition of
  csrc/gated_hifi_fwd.cu (expand, conv with the taps as shifted k-slices,
  branch, output) with every product through ``tf32.matmul`` in the
  kernel's k-order and accumulation (``rz_steps=1``), against the JAX package's fused Pallas block in
  interpret mode (as tests/test_torch_gated_hifi.py runs it) on the same
  numpy inputs: within KERNEL_RTOL of max|ref| at valid frames with 3
  products, outside it with 1.
* A frame-deep product of the weight-gradient reduction (one slice of 8,192
  frames, 128 x 128) against fp64: within WGRAD_RTOL by a wide margin.
* The tensor cores' truncating accumulation, modelled (``rz_steps``): why
  the forward adds each k-step's MMAs to its accumulators in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_GRAD_RTOL, DX_RTOL, KERNEL_RTOL, WGRAD_RTOL, randomize
from speech_masters_thesis_tpu.models.vqvae import blocks as jblocks
from speech_masters_thesis_tpu_torch.models.vqvae import blocks as tblocks
from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh
from speech_masters_thesis_tpu_torch.ops import tf32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of small torch ops (tf32.matmul's k-step loop): on one
    thread, so that a busy host's scheduler does not stall each op's thread
    pool. Modules that import this fixture get it too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _kernel_forward(x, lens, w: gh.GatedHiFiWeights, res_scale: float, passes: int,
                    rz_steps=None) -> torch.Tensor:
    """B1's forward by csrc/gated_hifi_fwd.cu's stages and epilogues, each
    product through ``tf32.matmul`` in the kernel's k-order: the expand over
    the W input channels; the conv over (tap, channel), tap-major, each tap
    the expand shifted by (j - half) * dil with zeros outside [0, T); the
    branch 1x1 over H channels, then scale * (acc + b1), then the expand's
    product again into the same accumulator; the gate's softmax over
    branches (num / den after the max), then u Wg."""
    B, T, W = x.shape
    H = 2 * W
    mm = lambda a, b, acc=None: tf32.matmul(a, b, passes, acc, rz_steps)
    rows = x.reshape(B * T, W)
    zps = []
    for d, (kernel, dil) in enumerate(zip(w.ks, w.dilations)):
        cols = slice(d * H, (d + 1) * H)
        a = torch.relu(mm(rows, w.wall[:, cols]) + w.ball[cols]).reshape(B, T, H)
        k = kernel.shape[0]
        taps = torch.cat([gh._shift_time(a, (j - (k - 1) // 2) * dil) for j in range(k)], dim=-1)
        h1 = torch.relu(mm(taps.reshape(B * T, k * H), kernel.reshape(k * H, H)) + w.cb[d])
        acc = res_scale * (mm(h1, w.w1[d]) + w.b1[d])
        zps.append(mm(rows, w.wall[:, cols], acc) + w.ball[cols])
    ts = torch.stack([zp[:, :W] for zp in zps])
    ss = torch.stack([zp[:, W:] for zp in zps])
    e = torch.exp(ss - ss.amax(dim=0))
    num, den = torch.zeros_like(ts[0]), torch.zeros_like(ts[0])
    for d in range(len(zps)):  # the kernel's order over branches
        den = den + e[d]
        num = num + torch.tanh(ts[d]) * e[d]
    out = x + res_scale * (mm(num / den, w.wg).reshape(B, T, W) + w.bg)
    valid = torch.arange(T)[None, :] < lens[:, None]
    return out * valid[..., None]


def _flax_params(sd: dict, depth: int) -> dict:
    conv = lambda name: {"kernel": np.transpose(sd[f"{name}.weight"], (2, 1, 0)), "bias": sd[f"{name}.bias"]}
    params = {"gate": conv("gate")}
    for d in range(depth):
        params[f"branch_in_{d}"] = conv(f"blocks.{d}.0")
        params[f"branch_res_{d}"] = {"Conv_0": conv(f"blocks.{d}.1.model.2"), "Conv_1": conv(f"blocks.{d}.1.model.5")}
    return {"params": params}


@pytest.mark.parametrize("W,depth,T,res_scale", [(64, 4, 256, False), (16, 2, 200, True)])
def test_forward_stages_in_3xtf32_meet_kernel_rtol_against_jax(W, depth, T, res_scale):
    block = tblocks.GatedHiFiBlock(W, depth, dilation_growth_rate=3, kernel_size_growth_rate=2,
                                   zero_out=False, res_scale=res_scale)
    randomize(block, seed=depth * 100 + T)  # chip_smoke's weights: lecun-normal, biases N(0, 0.1^2)
    rng = np.random.RandomState(T)
    x = rng.uniform(-1, 1, (2, T, W)).astype(np.float32)
    lens = np.array([T, T - 37], dtype=np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    sd = {k: v.detach().numpy() for k, v in block.state_dict().items()}
    ref, _ = jblocks.GatedHiFiBlock(fused=True, n_in=W, n_depth=depth, dilation_growth_rate=3,
                                    kernel_size_growth_rate=2, zero_out=False, res_scale=res_scale).apply(
        _flax_params(sd, depth), jnp.asarray(x), jnp.asarray(mask), train=False)
    valid = mask[..., 0].astype(bool)
    ref = np.asarray(ref)[valid]
    scale = np.abs(ref).max()
    w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    xm, lens_t = torch.from_numpy(x * mask), torch.from_numpy(lens)
    with torch.no_grad():  # each k-step's MMAs truncating from zero, then added in fp32, as the kernel runs them
        out3 = _kernel_forward(xm, lens_t, w, block.res_scale, passes=3, rz_steps=1).numpy()
        out1 = _kernel_forward(xm, lens_t, w, block.res_scale, passes=1, rz_steps=1).numpy()
    err3 = np.abs(out3[valid] - ref).max() / scale
    err1 = np.abs(out1[valid] - ref).max() / scale
    assert np.all(out3[~valid] == 0.0)
    assert err3 <= KERNEL_RTOL / 10, err3    # 3 products: well inside the unchanged tolerance
    assert err1 > KERNEL_RTOL, err1          # 1 product would miss it


def _frame_deep_slice():
    """One slice of the weight-gradient reduction at the main path's depth
    (16 x 33024 frames over 64 slices: about 8,192 frames), a conv tap's
    a^T dc: [128 x 8192] relu activations by [8192 x 128] cotangents."""
    rng = np.random.RandomState(3)
    a = np.maximum(rng.randn(8192, 128), 0.0).astype(np.float32)
    dc = (rng.randn(8192, 128) * 1e-3).astype(np.float32)
    at, dct = torch.from_numpy(a.T.copy()), torch.from_numpy(dc)
    return at, dct, at.double() @ dct.double()


@pytest.mark.parametrize("rz_steps", [None, 128])
def test_frame_deep_reduction_meets_wgrad_rtol(rz_steps):
    """The slice as the kernel runs it: the frames are the products' k, 8 at
    a time, each MMA's sum rounded to nearest (None, the arithmetic's ideal)
    or, as modelled for the tensor cores, truncated in a register that the
    kernel adds into its partial in fp32 every 32 slabs of 32 frames (128
    k-steps). Against fp64: 1.8e-6 and 9.8e-6 of max|ref|, 100x inside
    WGRAD_RTOL or better (one register for the whole slice: 8.7e-5)."""
    at, dct, ref = _frame_deep_slice()
    err = (tf32.matmul(at, dct, passes=3, rz_steps=rz_steps).double() - ref).abs().max().item()
    assert err / ref.abs().max().item() <= WGRAD_RTOL / 100, err


def test_truncating_accumulation_needs_fp32_adds_between_mmas():
    """The tensor cores' fp32 accumulation truncates each MMA's sum, so its
    error grows with the MMAs that meet one register. Modelled (tf32.matmul's
    rz_steps) at chip_smoke's weights and against fp64: B1's forward with
    every product's MMAs in one register (432 for a conv output) is 5x or
    more the fp32 plain version's error (the card measured 6.7e-6 of
    max|out| against the plain version, 8x the old fp32 kernel's), and with
    each k-step's MMAs added to the accumulator in fp32 (as
    gated_hifi_tiles.cuh:mma_tile runs them) no worse than the plain
    version's; the reduction's
    frame-deep slice loses 5x or more with one register for all its MMAs
    than with the kernel's add into its partial every 128 k-steps."""
    block = tblocks.GatedHiFiBlock(64, 4, dilation_growth_rate=3, kernel_size_growth_rate=2, zero_out=True)
    randomize(block, seed=1)
    w = gh.pack_weights({k: v.detach() for k, v in block.named_parameters()}, block.dilations)
    w64 = gh._weights_from({k: v.double() for k, v in w.tensors().items()}, w.dilations)
    rng = np.random.RandomState(100)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 256, 64)).astype(np.float32))
    lens = torch.tensor([256, 200], dtype=torch.int32)
    x = x * (torch.arange(256)[None, :] < lens[:, None])[..., None]
    with torch.no_grad():
        ref = gh.gated_hifi_reference(x.double(), lens, w64)
        scale = ref.abs().max().item()
        err = lambda out: (out.double() - ref).abs().max().item() / scale
        plain = err(gh.gated_hifi_reference(x, lens, w))
        one_register = err(_kernel_forward(x, lens, w, 1.0, 3, rz_steps=0))
        per_kstep = err(_kernel_forward(x, lens, w, 1.0, 3, rz_steps=1))
    assert one_register >= 5 * plain, (one_register, plain)
    assert per_kstep <= plain, (per_kstep, plain)
    at, dct, ref = _frame_deep_slice()
    red = {r: (tf32.matmul(at, dct, passes=3, rz_steps=r).double() - ref).abs().max().item() for r in (0, 128)}
    assert red[0] >= 5 * red[128], red
