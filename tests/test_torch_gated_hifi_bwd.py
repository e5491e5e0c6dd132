"""The port's GatedHiFi backward and dropout masks
(speech_masters_thesis_tpu_torch/ops/gated_hifi.py) on the CPU.

* The plain version's dx and every weight gradient at p=0, through the
  port's block (so through ``pack_weights`` into the Conv1d parameters),
  match ``jax.grad`` through the JAX package's fused Pallas block in
  interpret mode (as tests/test_fused_block.py runs it): rtol 1e-4 /
  atol 1e-6 of each leaf's max (at least 1), fp32 with another summation
  order.
* The backward kernels' decomposition (``backward_buffers_reference`` then
  ``weight_grad_reduce_reference``, the formulas csrc/gated_hifi_bwd.cu
  computes) equals autograd of the plain forward, with and without dropout.
* The dropout masks: the hash equals the same formula in exact integer
  arithmetic (the kernels' uint32 semantics), is deterministic for a seed
  and differs across seeds, keeps 1 - p of each site within 5 sigma with the
  two sites independent, and a window starting at t0 equals the slice of
  the full mask.

The CUDA kernels run only on the card (chip_smoke.py phases 7 and 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.vqvae import blocks as jblocks
from speech_masters_thesis_tpu_torch.models.vqvae import blocks as tblocks
from speech_masters_thesis_tpu_torch.ops import gated_hifi as gh

W = 16
U32 = 0xFFFFFFFF


def _block(depth, seed, p_dropout=0.1):
    block = tblocks.GatedHiFiBlock(W, depth, dilation_growth_rate=3, kernel_size_growth_rate=2,
                                   zero_out=False, res_scale=True, p_dropout=p_dropout)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy((rng.randn(*p.shape) * 0.2).astype(np.float32)))
    return block


def _inputs(B, T, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, T, W)).astype(np.float32)
    lens = rng.randint(T // 2, T + 1, (B,)).astype(np.int32)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    g = rng.randn(B, T, W).astype(np.float32)
    return x, lens, mask, g


def _packed(block):
    with torch.no_grad():
        return gh.pack_weights(dict(block.named_parameters()), block.dilations)


@pytest.mark.parametrize("depth", [3, 4])
def test_plain_backward_matches_jax_fused_kernel(depth):
    block = _block(depth, seed=depth, p_dropout=0.0)
    sd = {k: v.detach().numpy() for k, v in block.state_dict().items()}
    x, _, mask, g = _inputs(2, 600, seed=10 + depth)

    conv = lambda name: {"kernel": np.transpose(sd[f"{name}.weight"], (2, 1, 0)),
                         "bias": sd[f"{name}.bias"]}
    params = {"gate": conv("gate")}
    for d in range(depth):
        params[f"branch_in_{d}"] = conv(f"blocks.{d}.0")
        params[f"branch_res_{d}"] = {"Conv_0": conv(f"blocks.{d}.1.model.2"),
                                     "Conv_1": conv(f"blocks.{d}.1.model.5")}
    jblock = jblocks.GatedHiFiBlock(n_in=W, n_depth=depth, dilation_growth_rate=3,
                                    kernel_size_growth_rate=2, zero_out=False, res_scale=True,
                                    fused=True, p_dropout=0.0)

    def loss(p, xx):
        y, _ = jblock.apply({"params": p}, xx, jnp.asarray(mask), train=True)
        return jnp.sum(y * jnp.asarray(g))

    jgrads, jdx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = block(xt, torch.from_numpy(mask), train=True, generator=torch.Generator())
    out.backward(torch.from_numpy(g))
    # atol 1e-6 of each leaf's scale: a weight gradient sums 1200 frames
    close = lambda ours, theirs, name: np.testing.assert_allclose(
        ours, theirs, rtol=1e-4, atol=1e-6 * max(1.0, np.abs(theirs).max()), err_msg=name)
    close(xt.grad.numpy(), np.asarray(jdx), "dx")
    ours = dict(block.named_parameters())

    def check(tree, name):
        close(ours[f"{name}.weight"].grad.numpy(), np.transpose(np.asarray(tree["kernel"]), (2, 1, 0)),
              name)
        close(ours[f"{name}.bias"].grad.numpy(), np.asarray(tree["bias"]), name)

    check(jgrads["gate"], "gate")
    for d in range(depth):
        check(jgrads[f"branch_in_{d}"], f"blocks.{d}.0")
        check(jgrads[f"branch_res_{d}"]["Conv_0"], f"blocks.{d}.1.model.2")
        check(jgrads[f"branch_res_{d}"]["Conv_1"], f"blocks.{d}.1.model.5")


@pytest.mark.parametrize("p_drop", [0.0, 0.1])
def test_kernel_decomposition_equals_autograd(p_drop):
    """Tile passes then reduction, as the CUDA backward splits it."""
    block = _block(4, seed=21)
    w = _packed(block)
    x, lens, mask, g = _inputs(2, 300, seed=22)
    args = (torch.from_numpy(x * mask), torch.from_numpy(lens), w, torch.from_numpy(g),
            block.res_scale, p_drop, 987654321)
    dx_ref, grads_ref = gh.gated_hifi_backward_reference(*args)
    dx, bufs = gh.backward_buffers_reference(*args)
    grads = gh.weight_grad_reduce_reference(args[0], bufs, w.kernels, w.dilations, block.res_scale)
    dx_cpu, grads_cpu = gh.gated_hifi_backward(*args)  # a CPU tensor runs the same plain pieces
    torch.testing.assert_close(dx, dx_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx_cpu, dx, rtol=0, atol=0)
    for name, ref in grads_ref.tensors().items():
        scale = ref.abs().max().item()
        torch.testing.assert_close(grads.tensors()[name], ref, rtol=1e-5, atol=1e-5 * scale, msg=name)
        torch.testing.assert_close(grads_cpu.tensors()[name], grads.tensors()[name], rtol=0, atol=0)
    # the buffers hold what the backward's passes hand on: a and h1 are the
    # masked activations, and dzp the cotangent of the branch outputs
    assert bufs.a.shape == bufs.dz.shape == (2, 300, 4 * 2 * W)
    assert bool((bufs.a >= 0).all()) and bool((bufs.h1 >= 0).all())
    torch.testing.assert_close(bufs.gv, block.res_scale * args[3] * torch.from_numpy(mask))


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def _bits(seed, b, d, t, c, hidden):
    key = _fmix32((_fmix32(seed) + (b * 8 + d + 1) * 0x9E3779B9) & U32)
    return _fmix32((_fmix32(key ^ ((t * hidden + c) & U32)) + key) & U32)


def test_mask_hash_equals_uint32_formula():
    seed, hidden = 4_000_000_000, 32
    bits = gh.dropout_bits(seed, 3, 2, -5, 40, hidden)
    want = [[[_bits(seed, b, 2, t, c, hidden) for c in range(hidden)] for t in range(-5, 35)]
            for b in range(3)]
    np.testing.assert_array_equal(bits.numpy(), np.array(want, dtype=np.int64))
    assert gh.dropout_key(seed, 1, 3) == _fmix32((_fmix32(seed) + 12 * 0x9E3779B9) & U32)


def test_masks_deterministic_and_seed_dependent():
    m0, m1 = gh.branch_masks(11, 2, 1, 0, 500, 64, 0.1)
    again = gh.branch_masks(11, 2, 1, 0, 500, 64, 0.1)
    other = gh.branch_masks(12, 2, 1, 0, 500, 64, 0.1)
    branch = gh.branch_masks(11, 2, 2, 0, 500, 64, 0.1)
    assert torch.equal(m0, again[0]) and torch.equal(m1, again[1])
    for a, b in ((m0, other[0]), (m1, other[1]), (m0, branch[0]), (m0[0], m0[1])):
        assert ((a > 0) != (b > 0)).float().mean() > 0.1
    assert set(torch.unique(m0).tolist()) == {0.0, gh.keep_scale(0.1)}


def test_mask_window_equals_slice_of_full_mask():
    """Keyed by absolute frame: a tile's halo gets the owning tile's bits."""
    full = gh.branch_masks(5, 3, 3, 0, 900, 32, 0.25)
    for t0, rows in ((0, 100), (128, 384), (517, 383)):
        window = gh.branch_masks(5, 3, 3, t0, rows, 32, 0.25)
        for f, w in zip(full, window):
            assert torch.equal(w, f[:, t0:t0 + rows])


@pytest.mark.parametrize("p_drop", [0.1, 0.5])
def test_keep_rates_within_5_sigma_and_sites_independent(p_drop):
    n0 = n1 = n01 = n = 0
    for d in range(4):
        m0, m1 = gh.branch_masks(2024, 4, d, 0, 2000, 64, p_drop)
        k0, k1 = m0 > 0, m1 > 0
        n0, n1, n01, n = n0 + int(k0.sum()), n1 + int(k1.sum()), n01 + int((k0 & k1).sum()), n + k0.numel()
    q = 1.0 - gh.keep_threshold(p_drop) / 65536.0
    assert abs(q - (1.0 - p_drop)) <= 2.0 ** -17
    for count, rate in ((n0, q), (n1, q), (n01, q * q)):
        assert abs(count / n - rate) <= 5 * np.sqrt(rate * (1 - rate) / n), (count / n, rate)


def test_dropout_in_the_plain_block():
    """Train mode draws one seed per call from the generator; same generator
    state, same output; the masks scale kept elements by 1/(1-p)."""
    block = _block(4, seed=31)
    x, lens, mask, _ = _inputs(2, 200, seed=32)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        a, _ = block(xt, mt, train=True, generator=torch.Generator().manual_seed(1))
        b, _ = block(xt, mt, train=True, generator=torch.Generator().manual_seed(1))
        c, _ = block(xt, mt, train=True, generator=torch.Generator().manual_seed(2))
        e, _ = block(xt, mt, train=False)
        seed = int(torch.randint(0, 2 ** 32, (1,), generator=torch.Generator().manual_seed(1)))
        ref = gh.gated_hifi_reference(xt * mt, torch.from_numpy(lens), _packed(block),
                                      block.res_scale, 0.1, seed)
    assert torch.equal(a, b) and torch.equal(a, ref)
    assert not torch.allclose(a, c) and not torch.allclose(a, e)
    with pytest.raises(ValueError, match="Generator"):
        block(xt, mt, train=True)


def test_res_layer_dropout_law():
    layer = tblocks.ResLayer(8, 8, dilation=1, kernel_size=3, zero_out=False, dropout=0.25)
    with torch.no_grad():
        layer.model[2].weight.zero_()
        layer.model[2].bias.fill_(1.0)   # conv output 1 everywhere: the site-2 mask shows
        layer.model[5].weight.copy_(torch.eye(8)[:, :, None])
        layer.model[5].bias.zero_()
        x = torch.zeros(4, 5000, 8)
        h = layer(x, train=True, generator=torch.Generator().manual_seed(3))
    values = torch.unique(h)
    assert torch.allclose(values, torch.tensor([0.0, 1 / 0.75]))
    kept = (h > 0).float().mean().item()
    assert abs(kept - 0.75) <= 5 * np.sqrt(0.75 * 0.25 / h.numel())
    torch.testing.assert_close(layer(x), torch.ones_like(x))  # eval: no dropout
