"""The port's small-T attention (ops/attention.py) against the JAX package's,
on the CPU.

The plain forward and its gradients are held to the JAX ``fused_attention``
Pallas kernel in interpret mode at p=0, with the tolerances of
tests/test_fused_attention.py (forward 1e-5, gradients 1e-4), and to the
JAX LM's unfused ``_attend`` at valid rows. The plain recompute backward
is held to torch autograd through the plain forward with dropout (fp64,
1e-10). The dropout hash is checked for determinism per seed, its law and
its bits against a pure-Python u32 implementation. The LM attention's three
routes are checked at T = 1024 and T = 1025. The CUDA kernels themselves run
only on the card (chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.models.transformer_lm.model import (
    MultiHeadSelfAttention as JaxAttention)
from speech_masters_thesis_tpu.ops.basic import sequence_mask as jax_sequence_mask
from speech_masters_thesis_tpu.ops.pallas.attention import SmallTAttnSpec
from speech_masters_thesis_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from speech_masters_thesis_tpu_torch.models.transformer_lm import model as lm_model
from speech_masters_thesis_tpu_torch.ops import attention as att

U32 = 0xFFFFFFFF


def _inputs(B=2, T=37, H=4, D=32, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    lens = rng.randint(1, T + 1, (B,)).astype(np.int32)
    lens[0] = T
    return q, k, v, g, lens


@pytest.mark.parametrize("T", [16, 37, 128, 257])
def test_plain_attention_matches_jax_kernel(T):
    q, k, v, g, lens = _inputs(T=T)
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    spec = SmallTAttnSpec(n_heads=q.shape[2], d_head=D, scale=scale, p_drop=0.0, interpret=True)
    lens_f32 = jax.lax.bitcast_convert_type(jnp.asarray(lens), jnp.float32)
    seed = jnp.float32(0.0)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jout, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(spec, seed, lens_f32, a, b, c), jq, jk, jv)
    jgrads = vjp(jg)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tlens = torch.from_numpy(lens)
    out = att.fused_attention(tq, tk, tv, tlens, torch.zeros(1, dtype=torch.int64), scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    autograd = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    plain = att.attention_backward_reference(tq.detach(), tk.detach(), tv.detach(), tlens, 0,
                                             torch.from_numpy(g), scale)
    for name, a, b, jgrad in zip("qkv", autograd, plain, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-4, err_msg=name)


def _jax_layer(C, H, T, B, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    lens = np.array([T, T - T // 3], np.int32)
    params = {"in_proj": {"kernel": rng.randn(C, 3 * C).astype(np.float32) / np.sqrt(C),
                          "bias": 0.1 * rng.randn(3 * C).astype(np.float32)},
              "out_proj": {"kernel": rng.randn(C, C).astype(np.float32) / np.sqrt(C),
                           "bias": 0.1 * rng.randn(C).astype(np.float32)}}
    return x, lens, params


def _port_layer(params, C, H, fused, dropout=0.0):
    layer = lm_model.MultiHeadSelfAttention(C, H, dropout, fused=fused)
    with torch.no_grad():
        layer.in_proj_weight.copy_(torch.from_numpy(params["in_proj"]["kernel"].T.copy()))
        layer.in_proj_bias.copy_(torch.from_numpy(params["in_proj"]["bias"]))
        layer.out_proj.weight.copy_(torch.from_numpy(params["out_proj"]["kernel"].T.copy()))
        layer.out_proj.bias.copy_(torch.from_numpy(params["out_proj"]["bias"]))
    return layer


def _jax_attend(params, x, lens, C, H):
    T = x.shape[1]
    key_mask = jax_sequence_mask(jnp.asarray(lens), T)
    causal = jnp.tril(jnp.ones((T, T)))
    bias = jnp.where((causal[None, None] * key_mask[:, None, None, :]) > 0, 0.0, -1e9)
    return np.asarray(JaxAttention(C, H, dropout=0.0, fused=False).apply(
        {"params": params}, jnp.asarray(x), bias, train=False, key_mask=key_mask))


def test_small_t_route_matches_jax_attend_at_valid_rows():
    """The LM attention through the small-T route against the JAX LM's
    unfused path (-1e9 additive bias), forward and input gradient at valid
    rows (masked rows differ by design and every consumer masks them)."""
    C, H, T, B = 128, 4, 29, 2
    x, lens, params = _jax_layer(C, H, T, B)
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None].astype(np.float32)

    def jloss(xx):
        key_mask = jax_sequence_mask(jnp.asarray(lens), T)
        causal = jnp.tril(jnp.ones((T, T)))
        bias = jnp.where((causal[None, None] * key_mask[:, None, None, :]) > 0, 0.0, -1e9)
        y = JaxAttention(C, H, dropout=0.0, fused=False).apply(
            {"params": params}, xx, bias, train=False, key_mask=key_mask)
        return jnp.sum((y * valid) ** 2), y

    (_, jy), jgx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    layer = _port_layer(params, C, H, fused=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = layer(tx, torch.from_numpy(lens), train=False)
    (gx,) = torch.autograd.grad(torch.sum((y * torch.from_numpy(valid)) ** 2), tx)
    np.testing.assert_allclose(y.detach().numpy() * valid, np.asarray(jy) * valid, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 37, 4, 8), (1, 70, 2, 32)])
def test_backward_reference_matches_autograd_with_dropout(shape):
    rng = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rng.randn(*shape)) for _ in range(4))  # float64
    lens = torch.tensor([shape[1], shape[1] // 2][:shape[0]], dtype=torch.int32)
    seed, scale, p = 987654321, 0.4, 0.1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = att.attention_reference(*leaves, lens, seed, scale, p)
    want = torch.autograd.grad(out, leaves, g)
    got = att.attention_backward_reference(q, k, v, lens, seed, g, scale, p)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)
    # dropout reached the result: another seed gives another output
    assert not torch.allclose(out, att.attention_reference(q, k, v, lens, seed + 1, scale, p))


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def _draw(seed, b, h, H, r, c, T):
    key = _fmix32((_fmix32(seed) + (b * H + h + 1) * 0x9E3779B9) & U32)
    return _fmix32((_fmix32(key ^ ((r * T + c) & U32)) + key) & U32)


def test_dropout_bits_law_and_determinism():
    B, H, T, p = 2, 3, 200, 0.1
    bits = att.dropout_bits(torch.tensor([4242], dtype=torch.int64), B, H, T)
    again = att.dropout_bits(4242, B, H, T)
    other = att.dropout_bits(4243, B, H, T)
    assert bits.shape == (B, H, T, T) and int(bits.min()) >= 0 and int(bits.max()) <= U32
    assert torch.equal(bits, again)
    assert (bits != other).float().mean().item() > 0.99
    for b, h, r, c in [(0, 0, 0, 0), (1, 2, 199, 3), (1, 0, 57, 140)]:
        assert int(bits[b, h, r, c]) == _draw(4242, b, h, H, r, c, T)
    kept = (bits >= att.keep_threshold(p)).double().mean().item()
    n = bits.numel()
    assert abs(kept - 0.9) <= 5 * math.sqrt(0.09 / n), kept
    mask = att.keep_mask(4242, B, H, T, p)
    assert set(torch.unique(mask).tolist()) == {0.0, att.keep_scale(p)}
    assert att.keep_threshold(0.1) == int(0.1 * 2 ** 32) and att.keep_threshold(0.0) == 0
    with pytest.raises(ValueError):
        att.keep_threshold(1.0)


@pytest.mark.parametrize("T,route", [(1024, "small_t"), (1025, "sdpa")])
def test_routing_at_the_small_t_bound(monkeypatch, T, route):
    """fused_attention: T <= 1024 takes the small-T route, T > 1024 without
    dropout takes SDPA, and T > 1024 with dropout the plain ``_attend``;
    each agrees with the JAX unfused path at valid rows."""
    C, H, B = 64, 2, 2
    x, lens, params = _jax_layer(C, H, T, B, seed=2)
    calls = []
    for name in ("_attend_smallt", "_attend_sdpa", "_attend"):
        orig = getattr(lm_model.MultiHeadSelfAttention, name)
        monkeypatch.setattr(lm_model.MultiHeadSelfAttention, name,
                            lambda self, *a, _n=name, _o=orig: calls.append(_n) or _o(self, *a))
    layer = _port_layer(params, C, H, fused=True, dropout=0.1)
    with torch.no_grad():
        y = layer(torch.from_numpy(x), torch.from_numpy(lens), train=False)
    assert calls == ["_" + ("attend_smallt" if route == "small_t" else "attend_sdpa")]
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None]
    np.testing.assert_allclose(y.numpy() * valid, _jax_attend(params, x, lens, C, H) * valid,
                               rtol=1e-5, atol=1e-5)
    calls.clear()
    with torch.no_grad():
        layer(torch.from_numpy(x), torch.from_numpy(lens), train=True,
              generator=torch.Generator().manual_seed(0))
    assert calls == ["_attend_smallt" if route == "small_t" else "_attend"]


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v, _, lens = _inputs(T=20, seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    before = att.fused_attention.launches
    seed = torch.tensor([7], dtype=torch.int64)
    out = att.fused_attention(*args, torch.from_numpy(lens), seed, 0.2, 0.1)
    torch.testing.assert_close(out, att.attention_reference(*args, torch.from_numpy(lens), 7, 0.2, 0.1))
    assert att.fused_attention.launches == before  # launches count kernel runs only
    with pytest.raises(ValueError, match="unsupported device"):
        att.fused_attention(*(a.to("meta") for a in args), torch.from_numpy(lens), seed, 0.2)
