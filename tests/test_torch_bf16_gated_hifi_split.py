"""B1's bf16 backward on its split buffers (ops/gated_hifi.py, the plain
versions of csrc/gated_hifi_bwd_bf16.cu), on the CPU.

In bf16 the tile passes store every product operand the reduction reads in
bf16 (dzp's product copy, dc, dz and gv rounded where the TPU kernel rounds
them at its dots) and hand the bias gradients over as fp32 column sums of
128-frame tiles (``BackwardBuffers.bias``). ``_fp32_cotangents`` reruns the
plain tile passes' formulas without the final casts: the fp32 values a
reduction that rounds at its products (the first bf16 form) would read.

Tolerances. (a) The product gradients come from the same rounded operands in
the same einsum, so they are equal bit for bit; the bias sums are the same
fp32 values added in another order (tiles of 128 frames, then the tiles), so
each column's difference stays within 2^-16 of the sum of its terms'
magnitudes (fp32 reordering of a few thousand terms: a few hundred ulps of
that sum at most). (b) against the JAX kernel's bf16 VJP: the module
docstring of test_torch_bf16_gated_hifi.py (99% within one bf16 ulp, all
within 2^-6 of max|ref|), at T = 260, 172 and 516 (remainders 4, 44 and 4
of the 128-frame tile; 172 and 516 are block lengths of VQ-TTS and the
VQ-VAE). The JAX block takes its lengths as the sum of a bf16 mask, so a
length above 256 that bf16 cannot hold reaches its kernel rounded (389 ->
388); the plain cases use bf16-exact lengths, and the last test runs 389
through the port's block, which rounds it the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh
from speech_masters_thesis_tpu_torch.ops.basic import round_bf16
from test_torch_bf16_gated_hifi import W, _block, _flax, _inputs, _jax, bf16_close
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REORDER_RTOL = 2.0 ** -16   # of a column's sum of |terms|: the bias sums in another order
PRODUCTS = ("wall", "wg", "w1")  # the product gradients besides every conv tap (ks.*)
Y_NAMES = ("dzp", "dc", "dz", "gv")  # the reduction's Y operands


def _fp32_cotangents(x, lens, w, g, p_drop, seed):
    """dzp, dc, dz and gv of the plain bf16 tile passes (res_scale 1) in fp32,
    before they are stored: backward_buffers_reference's formulas without
    its final casts."""
    T, H = x.shape[1], 2 * x.shape[2]
    keep = gh.keep_scale(p_drop)
    rnd, xf, wf = gh._operands(x, w)
    gv = g.float() * (torch.arange(T)[None, :] < lens[:, None])[..., None].float()
    du = rnd(gv) @ rnd(wf.wg).t()
    branches = gh._branches(xf, wf, 1.0, p_drop, seed, rnd)
    u, ps, ths = gh._gate([zp for *_, zp in branches], x.shape[2])
    out = {name: [] for name in ("dzp", "dc", "dz")}
    for d, ((a, h1, _), kernel, dil) in enumerate(zip(branches, wf.ks, wf.dilations)):
        dzp = torch.cat([du * ps[d] * (1 - ths[d] * ths[d]), du * ps[d] * (ths[d] - u)], dim=-1)
        dc = (rnd(dzp) @ rnd(wf.w1[d]).t()) * (h1 > 0) * keep
        half = (kernel.shape[0] - 1) // 2
        da = sum(gh._shift_time(rnd(dc), -(j - half) * dil) @ rnd(kernel[j]).t() for j in range(kernel.shape[0]))
        for name, t in (("dzp", dzp), ("dc", dc), ("dz", dzp + da * (a > 0) * keep)):
            out[name].append(t)
    assert all(t.shape[-1] == H for ts in out.values() for t in ts)
    return {**{name: torch.cat(ts, dim=-1) for name, ts in out.items()}, "gv": gv}


def _reduction_rounding_at_products(x, bufs, fp32, kernels, dilations):
    """The product gradients from fp32 Y operands rounded inside each
    product (the first bf16 form's reduction), each rounded to bf16 once."""
    H = 2 * x.shape[-1]
    outer = lambda p, q: torch.einsum("btm,btn->mn", round_bf16(p), round_bf16(q))
    ref = {"wall": outer(x, fp32["dz"]), "wg": outer(bufs.u, fp32["gv"])}
    w1s = []
    for d, (k, dil) in enumerate(zip(kernels, dilations)):
        cols = slice(d * H, (d + 1) * H)
        half = (k - 1) // 2
        ref[f"ks.{d}"] = torch.stack([outer(gh._shift_time(bufs.a[..., cols], (j - half) * dil),
                                            fp32["dc"][..., cols]) for j in range(k)])
        w1s.append(outer(bufs.h1[..., cols], fp32["dzp"][..., cols]))
    ref["w1"] = torch.stack(w1s)
    return {name: t.to(torch.bfloat16) for name, t in ref.items()}


def _buffers(depth, T, lens, seed, p_drop=0.0):
    block = _block(depth, seed=seed, res_scale=False)
    x, mask, g = _inputs(lens, T, seed=seed + 1)
    w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    with torch.no_grad():
        _, bufs = gh.backward_buffers_reference(x * mask, lens_t, w, g, 1.0, p_drop, 99)
        fp32 = _fp32_cotangents(x * mask, lens_t, w, g, p_drop, 99)
    return w, x * mask, bufs, fp32


SHAPES = [(4, 260, (260, 201)), (3, 172, (172, 150)), (4, 516, (516, 388))]


@pytest.mark.parametrize("depth,T,lens", SHAPES)
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_split_reduction_equals_rounding_at_the_product(depth, T, lens, p_drop):
    """(a) The plain reduction on bf16 buffers and fp32 bias partials against
    a reduction that rounds the fp32 cotangents at its products: every conv
    tap, dW1, dWg and dWall bit for bit; every bias within REORDER_RTOL."""
    w, x, bufs, fp32 = _buffers(depth, T, lens, seed=depth * 7 + T, p_drop=p_drop)
    for name in Y_NAMES:
        assert getattr(bufs, name).dtype == torch.bfloat16 and fp32[name].dtype == torch.float32
        assert torch.equal(getattr(bufs, name), fp32[name].to(torch.bfloat16)), name
    with torch.no_grad():
        ours = gh.weight_grad_reduce_reference(x, bufs, w.kernels, w.dilations).tensors()
        ref = _reduction_rounding_at_products(x, bufs, fp32, w.kernels, w.dilations)
    for name in [*PRODUCTS, *(f"ks.{d}" for d in range(depth))]:
        assert ours[name].dtype == torch.bfloat16
        assert torch.equal(ours[name], ref[name]), name
    # the biases in fp32, before their one rounding: the tile sums against the whole sums
    ldw = depth * 2 * W
    sums = dict(zip(("ball", "cb", "b1", "bg"), torch.split(bufs.bias.sum(dim=0), [ldw, ldw, ldw, W])))
    terms = {"ball": fp32["dz"], "cb": fp32["dc"], "b1": fp32["dzp"], "bg": fp32["gv"]}
    for name, t in terms.items():
        whole, scale = t.sum(dim=(0, 1)), t.abs().sum(dim=(0, 1))
        assert bool(((sums[name] - whole).abs() <= REORDER_RTOL * scale).all()), name
        # and the bf16 gradients, rounded once from either sum, within one rounding step
        one_ulp = 2.0 ** (torch.floor(torch.log2(whole.abs().clamp_min(1e-30))) - 7)
        diff = (ours[name].float().reshape(-1) - whole.to(torch.bfloat16).float()).abs()
        assert bool((diff <= one_ulp).all()), name


def test_bias_partials_count_each_frame_once():
    """(c) One row a 128-frame tile of its own sequence: ceil(T / 128) rows a
    sequence, no tile past T, the last tile its T % 128 frames; the rows add
    up to the column sums."""
    B, T = 3, 300                                     # tiles of 128, 128 and 44 frames
    frames = torch.arange(T, dtype=torch.float32)
    ones = torch.ones(B, T, 2)
    seq = torch.arange(B, dtype=torch.float32)[:, None, None].expand(B, T, 1)
    at = frames[None, :, None].expand(B, T, 1)
    part = gh.bias_partials(ones, seq, at)
    n = -(-T // gh.BIAS_TILE)
    assert part.shape == (B * n, 4) and n == 3
    counts = part[:, 0].view(B, n)
    assert counts.tolist() == [[128.0, 128.0, 44.0]] * B
    assert part[:, 2].tolist() == [float(b * c) for b in range(B) for c in (128, 128, 44)]
    starts = [0, 128, 256]
    for b in range(B):
        for i, (t0, c) in enumerate(zip(starts, (128, 128, 44))):
            assert part[b * n + i, 3].item() == sum(range(t0, t0 + c))  # exactly these frames
    torch.testing.assert_close(part.sum(dim=0), torch.cat([ones, seq, at], -1).sum(dim=(0, 1)), rtol=0, atol=0)
    # T a multiple of the tile: no empty row
    assert gh.bias_partials(torch.ones(2, 256, 1)).view(-1).tolist() == [128.0] * 4


@pytest.mark.parametrize("depth,T,lens", SHAPES[:2])
def test_bias_partials_are_the_tile_passes_fp32_sums(depth, T, lens):
    """(c) The plain tile passes' partials are the per-tile sums of the fp32
    dz | dc | dzp | gv, before any rounding, at ragged lengths and T not a
    multiple of the tile (260 = 2 x 128 + 4, 172 = 128 + 44)."""
    _, _, bufs, fp32 = _buffers(depth, T, lens, seed=depth + T, p_drop=0.1)
    assert torch.equal(bufs.bias, gh.bias_partials(fp32["dz"], fp32["dc"], fp32["dzp"], fp32["gv"]))
    assert bufs.bias.shape == (len(lens) * -(-T // gh.BIAS_TILE), 3 * depth * 2 * W + W)


@pytest.mark.parametrize("depth,T,lens", SHAPES)
def test_split_vjp_matches_jax_kernel(depth, T, lens):
    """(b) The whole plain bf16 VJP on the split buffers (backward_buffers_reference
    then weight_grad_reduce_reference) against jax.vjp of the fused block's
    bf16 mode, its kernel in interpret mode: ragged lengths, T not a multiple
    of the 128-frame tile, depth 3 and 4."""
    block = _block(depth, seed=3 * depth + T, res_scale=False)
    x, mask, g = _inputs(lens, T, seed=T + 5)
    jblock, params = _flax(block, depth)
    _, vjp = jax.vjp(lambda p, xx: jblock.apply({"params": p}, xx, _jax(mask), train=False)[0], params, _jax(x))
    jgrads, jdx = vjp(_jax(g))
    w = gh.pack_weights(dict(block.named_parameters()), block.dilations)
    with torch.no_grad():
        dx, bufs = gh.backward_buffers_reference(x * mask, torch.tensor(lens, dtype=torch.int32), w, g)
        grads = gh.weight_grad_reduce_reference(x * mask, bufs, w.kernels, w.dilations).tensors()
    assert bufs.bias is not None and bufs.dc.dtype == torch.bfloat16
    valid = mask[..., 0].bool().numpy()
    bf16_close((dx * mask).float().numpy()[valid], np.asarray(jdx.astype(jnp.float32))[valid], "dx")
    H = 2 * W
    f = lambda t: np.asarray(t.astype(jnp.float32))
    conv = lambda tree: (f(tree["kernel"]), f(tree["bias"]))   # kernel [k, in, out]
    wg, bg = conv(jgrads["gate"])
    bf16_close(grads["wg"].float().numpy(), wg[0], "wg")
    bf16_close(grads["bg"].float().numpy(), bg, "bg")
    for d in range(depth):
        cols = slice(d * H, (d + 1) * H)
        wall, ball = conv(jgrads[f"branch_in_{d}"])
        kd, cb = conv(jgrads[f"branch_res_{d}"]["Conv_0"])
        w1, b1 = conv(jgrads[f"branch_res_{d}"]["Conv_1"])
        bf16_close(grads["wall"][:, cols].float().numpy(), wall[0], f"wall.{d}")
        bf16_close(grads["ball"][cols].float().numpy(), ball, f"ball.{d}")
        bf16_close(grads[f"ks.{d}"].float().numpy(), kd, f"ks.{d}")
        bf16_close(grads["cb"][d].float().numpy(), cb, f"cb.{d}")
        bf16_close(grads["w1"][d].float().numpy(), w1[0], f"w1.{d}")
        bf16_close(grads["b1"][d].float().numpy(), b1, f"b1.{d}")


def test_split_vjp_through_the_block_at_a_length_bf16_rounds():
    """Depth 4, T = 516 and a length of 389, which a bf16 mask sums to 388:
    the port's block (GatedHiFiFunction over the split plain versions on the
    CPU) takes the rounded length as the JAX block does. Its dx agrees with
    the JAX kernel's and its weight cotangents are the plain split VJP's at
    388 bit for bit; the plain VJP at the unrounded 389 takes a frame of g
    that both blocks drop, and its dx misses."""
    depth, T, lens = 4, 516, (516, 389)
    block = _block(depth, seed=528, res_scale=False)
    x, mask, g = _inputs(lens, T, seed=T + 5)
    rounded = torch.tensor(lens, dtype=torch.bfloat16).to(torch.int32)
    assert rounded.tolist() == [516, 388]
    jblock, params = _flax(block, depth)
    _, vjp = jax.vjp(lambda p, xx: jblock.apply({"params": p}, xx, _jax(mask), train=False)[0], params, _jax(x))
    jdx = np.asarray(vjp(_jax(g))[1].astype(jnp.float32))
    xl = x.clone().requires_grad_(True)
    out, _ = block(xl, mask)
    out.backward(g)
    valid = mask[..., 0].bool().numpy()
    bf16_close(xl.grad.float().numpy()[valid], jdx[valid], "dx")
    w = gh.pack_weights({k: v.detach() for k, v in block.named_parameters()}, block.dilations)
    with torch.no_grad():
        _, bufs = gh.backward_buffers_reference(x * mask, rounded, w, g)
        plain = gh.weight_grad_reduce_reference(x * mask, bufs, w.kernels, w.dilations)
        dx_389, _ = gh.backward_buffers_reference(x * mask, torch.tensor(lens, dtype=torch.int32), w, g)
    ours = gh.pack_weights({k: v.grad for k, v in block.named_parameters()}, block.dilations).tensors()
    for name, t in plain.tensors().items():
        assert torch.equal(ours[name], t), name
    with pytest.raises(AssertionError, match="within one bf16 ulp"):
        bf16_close((dx_389 * mask).float().numpy()[valid], jdx[valid], "dx at 389")
