"""B1's bf16 mode (speech_masters_thesis_tpu_torch/ops/gated_hifi.py) against
the JAX package's fused Pallas block in bf16, on the CPU.

The TPU kernel's bf16 mode (dot_dtype = the input's dtype) rounds each
product's operands to bf16 and sums in fp32; the port's plain versions round
at the same points. The same numpy weights and inputs, rounded to bf16, go
through the port's plain forward and backward (directly and through the
port's block, whose CPU bf16 route is ``GatedHiFiFunction`` over the plain
versions) and through the JAX block with fused=True, its kernel in interpret
mode at p=0 (as tests/test_torch_gated_hifi.py runs it).

Tolerances. Both sides compute the same fp32 intermediates up to the order
of their sums, so an fp32 value near a bf16 rounding boundary can round one
ulp apart before the next product, and the outputs are rounded to bf16 once
more: at least 99% of the valid elements of out, dx and every weight
cotangent must be within one bf16 ulp of their own magnitude (2^-7 of the
power of two below them), and all within 2^-6 of the tensor's max|ref|.
Both blocks sum a bf16 mask in bf16, so a length above 256 that bf16 cannot
hold rounds before the kernel takes it; the cases below are bf16-exact but
for the one test of that rounding.

Dropout. The JAX kernel draws its masks from the TPU's hardware PRNG, which
has no interpret-mode lowering; the forward cases at p = 0.1 replace its
``_branch_masks`` with the port's hash (ops/gated_hifi.py:dropout_bits in
jnp uint32 ops), so both sides drop the same elements, and let the JAX
block run its kernel in train mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.vqvae import blocks as jblocks
from speech_masters_thesis_tpu.ops.pallas import gated_hifi as jgh
from speech_masters_thesis_tpu_torch.models.vqvae import blocks as tblocks
from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh
from speech_masters_thesis_tpu_torch.ops.hash import GOLDEN
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

W = 16
ULP_SHARE = 0.99       # of elements within one bf16 ulp of their own magnitude
MAX_RTOL = 2.0 ** -6   # of max|ref|, every element



def _block(depth, seed, res_scale):
    block = tblocks.GatedHiFiBlock(W, depth, dilation_growth_rate=3, kernel_size_growth_rate=2,
                                   zero_out=False, res_scale=res_scale, p_dropout=0.0)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy((rng.randn(*p.shape) * 0.2).astype(np.float32)))
    return block.to(torch.bfloat16)


def _inputs(lens, T, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (len(lens), T, W)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)[..., None]
    g = rng.randn(len(lens), T, W).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    return bf(x), bf(mask), bf(g)


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _flax(block, depth, p_drop=0.0):
    sd = {k: v.float().numpy() for k, v in block.state_dict().items()}
    conv = lambda name: {"kernel": _jax(torch.from_numpy(np.transpose(sd[f"{name}.weight"], (2, 1, 0)).copy())),
                         "bias": _jax(torch.from_numpy(sd[f"{name}.bias"]))}
    params = {"gate": conv("gate")}
    for d in range(depth):
        params[f"branch_in_{d}"] = conv(f"blocks.{d}.0")
        params[f"branch_res_{d}"] = {"Conv_0": conv(f"blocks.{d}.1.model.2"),
                                     "Conv_1": conv(f"blocks.{d}.1.model.5")}
    jblock = jblocks.GatedHiFiBlock(n_in=W, n_depth=depth, dilation_growth_rate=3, kernel_size_growth_rate=2,
                                    zero_out=False, res_scale=block.res_scale != 1.0, fused=True,
                                    p_dropout=p_drop)
    return jblock, params


def _hash_masks(seed: int):
    """A stand-in for the JAX kernel's ``_branch_masks``: the port's masks
    of ``seed`` (gh.branch_masks) over the kernel's window of absolute frames
    chunk0 * CHUNK ..., the hash in jnp uint32 ops on the kernel's traced
    sequence index."""
    u32 = jnp.uint32

    def fmix(h):
        h = h ^ (h >> 16)
        h = h * u32(0x85EBCA6B)
        h = h ^ (h >> 13)
        h = h * u32(0xC2B2AE35)
        return h ^ (h >> 16)

    def masks(spec, _seed, b, d, chunk0, rows, cols):
        if spec.p_drop <= 0.0:
            return None, None
        stream = (b * gh.MASK_KEY_DEPTH + d + 1).astype(u32)
        key = fmix(fmix(u32(seed)) + stream * u32(GOLDEN))
        t = chunk0 * jgh.CHUNK + jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 0)
        counter = (t * cols + jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 1)).astype(u32)
        bits = fmix(fmix(key ^ counter) + key)
        th, scale = u32(gh.keep_threshold(spec.p_drop)), jnp.float32(gh.keep_scale(spec.p_drop))
        return (((bits >> 16) >= th).astype(jnp.float32) * scale,
                ((bits & u32(0xFFFF)) >= th).astype(jnp.float32) * scale)
    return masks


def bf16_close(ours, ref, what: str):
    """The module docstring's tolerance: (share within 1 ulp, max error / max|ref|)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    err = np.abs(ours - ref)
    share = float(np.mean(err <= ulp))
    worst = float(err.max() / max(np.abs(ref).max(), 1e-30))
    assert share >= ULP_SHARE, f"{what}: {share:.4f} of elements within one bf16 ulp"
    assert worst <= MAX_RTOL, f"{what}: max error {worst:.3e} of max|ref|"
    return share, worst


CASES = [(4, 100, (100, 61), False), (4, 500, (500, 384), False), (3, 160, (160, 96), True)]
# the bf16 forward's tiles (csrc/gated_hifi_fwd_bf16.cu: 128 frames in its expand, 64 in its conv and gate
# stages) at their edges: lengths on and one past a tile, 4 frames past the last whole one; depth 4's
# longest halo (108 frames) exceeds the last tile's remainder (44 at T = 172, 4 at T = 516)
EDGE_CASES = [(4, 172, (172, 128, 65, 100), False), (4, 516, (516, 384, 258, 65), False)]
DROP_SEED = 97531


FORWARD_CASES = ([pytest.param(*case, 0.0, id=f"{case[0]}-{case[1]}-lens{i}-{case[3]}") for i, case in enumerate(CASES)]
                 + [pytest.param(*case, p, id=f"edge-{case[1]}-p{p}") for case in EDGE_CASES for p in (0.0, 0.1)])


@pytest.mark.parametrize("depth,T,lens,res_scale,p_drop", FORWARD_CASES)
def test_forward_bf16_matches_jax_kernel(depth, T, lens, res_scale, p_drop, monkeypatch):
    block = _block(depth, seed=depth * 10 + T, res_scale=res_scale)
    x, mask, _ = _inputs(lens, T, seed=T)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    with torch.no_grad():
        ours = gh.gated_hifi_reference(x * mask, lens_t, w, block.res_scale, p_drop, DROP_SEED)
        if p_drop == 0.0:
            ours_block, _ = block(x, mask)
            torch.testing.assert_close(ours_block, ours, rtol=0, atol=0)
    assert ours.dtype == torch.bfloat16

    jblock, params = _flax(block, depth, p_drop)
    if p_drop > 0:
        monkeypatch.setattr(jgh, "_branch_masks", _hash_masks(DROP_SEED))
        monkeypatch.setattr(jblocks.GatedHiFiBlock, "uses_kernel", staticmethod(lambda fused, train, p: fused))
    theirs, _ = jblock.apply({"params": params}, _jax(x), _jax(mask), train=p_drop > 0,
                             rngs={"dropout": jax.random.PRNGKey(0)})
    assert theirs.dtype == jnp.bfloat16
    valid = mask[..., 0].bool().numpy()
    bf16_close(ours.float().numpy()[valid], np.asarray(theirs.astype(jnp.float32))[valid], "out")
    assert bool((ours.float().numpy()[~valid] == 0).all())


def test_block_rounds_ragged_lengths_as_the_jax_block():
    """Lengths 301 and 263 in bf16 are 300 and 264: the port's block runs the
    kernel to those lengths as the JAX block does, so frame 300 of the first
    row is zero in both and frame 263 of the second (past the mask) is
    computed in both."""
    depth, T, lens = 2, 320, (301, 263)
    block = _block(depth, seed=7, res_scale=False)
    x, mask, _ = _inputs(lens, T, seed=8)
    rounded = torch.tensor(lens, dtype=torch.bfloat16).to(torch.int32)
    assert rounded.tolist() == [300, 264]
    w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    with torch.no_grad():
        ours, _ = block(x, mask)
        at_rounded = gh.gated_hifi_reference(x * mask, rounded, w)
    torch.testing.assert_close(ours, at_rounded, rtol=0, atol=0)

    jblock, params = _flax(block, depth)
    theirs, _ = jblock.apply({"params": params}, _jax(x), _jax(mask), train=False)
    theirs = np.asarray(theirs.astype(jnp.float32))
    bf16_close(ours.float().numpy(), theirs, "out")
    assert ours[0, 300].eq(0).all() and (theirs[0, 300] == 0).all()
    assert ours[1, 263].ne(0).any() and (theirs[1, 263] != 0).any()


@pytest.mark.parametrize("depth,T,lens,res_scale", CASES[::2])
def test_vjp_bf16_matches_jax_kernel(depth, T, lens, res_scale):
    """dx and every weight cotangent, through the port's block (pack_weights,
    GatedHiFiFunction on the CPU) and the plain backward, against jax.vjp of
    the fused block."""
    block = _block(depth, seed=depth + T, res_scale=res_scale)
    x, mask, g = _inputs(lens, T, seed=T + 1)
    jblock, params = _flax(block, depth)
    _, vjp = jax.vjp(lambda p, xx: jblock.apply({"params": p}, xx, _jax(mask), train=False)[0],
                     params, _jax(x))
    jgrads, jdx = vjp(_jax(g))

    xl = x.clone().requires_grad_(True)
    out, _ = block(xl, mask)
    out.backward(g)
    assert xl.grad.dtype == torch.bfloat16
    valid = mask[..., 0].bool().numpy()
    bf16_close(xl.grad.float().numpy()[valid], np.asarray(jdx.astype(jnp.float32))[valid], "dx")
    # the plain backward alone equals the block's route bit for bit (past lens
    # the block's x * mask zeroes dx)
    with torch.no_grad():
        w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
        dx_plain, _ = gh.gated_hifi_backward_reference(x * mask, torch.tensor(lens, dtype=torch.int32), w, g,
                                                       block.res_scale)
    torch.testing.assert_close(xl.grad, dx_plain * mask, rtol=0, atol=0)

    ours = dict(block.named_parameters())

    def check(tree, name):
        for leaf, suffix in (("kernel", "weight"), ("bias", "bias")):
            grad = ours[f"{name}.{suffix}"].grad
            assert grad.dtype == torch.bfloat16
            ref = np.asarray(tree[leaf].astype(jnp.float32))
            if leaf == "kernel":
                ref = np.transpose(ref, (2, 1, 0))
            bf16_close(grad.float().numpy(), ref, f"{name}.{suffix}")

    check(jgrads["gate"], "gate")
    for d in range(depth):
        check(jgrads[f"branch_in_{d}"], f"blocks.{d}.0")
        check(jgrads[f"branch_res_{d}"]["Conv_0"], f"blocks.{d}.1.model.2")
        check(jgrads[f"branch_res_{d}"]["Conv_1"], f"blocks.{d}.1.model.5")


def test_plain_bf16_rounds_where_the_tpu_kernel_rounds():
    """The bf16 plain forward is the fp32 plain forward on bf16-rounded
    operands at the kernel's product inputs: against the fp32 plain version
    of the same bf16 values it differs by bf16-sized steps, and the weight
    gradients come back in bf16 from an fp32 sum (a bf16 torch.matmul would
    round every partial product's output as well)."""
    block = _block(4, seed=5, res_scale=False)
    x, mask, g = _inputs((200, 150), 200, seed=6)
    lens = torch.tensor((200, 150), dtype=torch.int32)
    with torch.no_grad():
        w16 = gh.pack_weights(dict(block.named_parameters()), block.dilations)
        w32 = gh.pack_weights({k: v.float() for k, v in block.named_parameters()}, block.dilations)
        out16 = gh.gated_hifi_reference(x * mask, lens, w16).float()
        out32 = gh.gated_hifi_reference((x * mask).float(), lens, w32)
        dx, grads = gh.gated_hifi_backward_reference(x * mask, lens, w16, g)
        _, bufs = gh.backward_buffers_reference(x * mask, lens, w16, g)
    rel = ((out16 - out32).abs().max() / out32.abs().max()).item()
    assert 2.0 ** -12 < rel < 2.0 ** -5
    assert dx.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in grads.tensors().values())
    assert bufs.a.dtype == bufs.h1.dtype == bufs.u.dtype == torch.bfloat16
    # the cotangents are stored rounded, as the TPU kernel rounds them at its
    # products; the bias gradients' fp32 column sums come beside them
    assert bufs.dzp.dtype == bufs.dc.dtype == bufs.dz.dtype == bufs.gv.dtype == torch.bfloat16
    assert bufs.bias.dtype == torch.float32 and bufs.bias.shape == (2 * 2, 3 * 4 * 2 * W + W)


def test_mixed_dtypes_raise():
    block = _block(2, seed=1, res_scale=False)
    x, mask, _ = _inputs((50,), 50, seed=2)
    w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    with pytest.raises(ValueError, match="share one dtype"):
        gh.gated_hifi_reference(x.float(), torch.tensor([50], dtype=torch.int32), w)
