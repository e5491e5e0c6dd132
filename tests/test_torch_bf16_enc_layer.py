"""B5's bf16 mode (speech_masters_thesis_tpu_torch/ops/enc_layer.py) against
the JAX package's fused_enc_layer in bf16, on the CPU.

The TPU kernel's bf16 mode (dot_dtype = x's dtype, ``_dot_nn/_nt/_tn``)
rounds the operands of every product (q/k/v, the scores and relative-key
logits, P V after dropout, the relative-value band, the out-projection, the
FFN convs, and in the backward their transposes and weight products) to
bf16 and sums in fp32; LayerNorm, the softmax and the masks stay fp32; the
output and dx come out in bf16, the weight gradients cast to bf16 from fp32
sums. The same numpy weights, rounded to bf16, go through the port's plain
forward and recompute backward (directly, and through ``enc_layer``, whose
CPU bf16 route is ``EncLayerFunction`` over them) and through the JAX
kernel in interpret mode at p=0, at ragged lengths.

Tolerances as tests/test_torch_bf16_wn_coupling.py's: the forward ULP_SHARE
within one bf16 ulp and all within MAX_RTOL of max|ref| at valid rows; dx
and every weight gradient within SUM_RTOL relative L2 over a norm floored
at SUM_RTOL of the largest leaf's (the key bias's true gradient is zero).
The control skips the rounding of the attention probabilities before P V:
the forward's relative L2 error against JAX then reads 2.3e-3, above
CONTROL_L2, where the port's plain forward reads 0. The unfused layer (the config's
route in VQ-TTS and Glow-TTS) is held against the JAX package's flax layers
in bf16 by tests/test_torch_bf16_vqtts_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.ops.pallas.enc_layer import EncLayerSpec, fused_enc_layer
from speech_masters_thesis_tpu_torch.ops import enc_layer as el
from speech_masters_thesis_tpu_torch.ops.basic import round_bf16
from test_torch_bf16_wn_coupling import CONTROL_L2, MAX_RTOL, SUM_RTOL, ULP_SHARE, agreement
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

C, HEADS, WINDOW, F, K = 16, 2, 4, 24, 3
D = C // HEADS


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)


def _case(T, seed):
    rng = np.random.RandomState(seed)
    lens = np.array([T, max(1, T // 2 + 1)], np.int32)
    valid = np.arange(T)[None, :] < lens[:, None]
    bf = lambda a: np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16))  # noqa: E731
    x = bf(rng.randn(2, T, C))
    g = bf(rng.randn(2, T, C) * valid[..., None])
    w = lambda *shape, fan: bf(rng.randn(*shape) / np.sqrt(fan))  # noqa: E731
    p = {"wq": w(C, C, fan=C), "bq": w(1, C, fan=10), "wk": w(C, C, fan=C), "bk": w(1, C, fan=10),
         "wv": w(C, C, fan=C), "bv": w(1, C, fan=10), "rk": w(2 * WINDOW + 1, D, fan=D),
         "rv": w(2 * WINDOW + 1, D, fan=D), "wo": w(C, C, fan=C), "bo": w(1, C, fan=10),
         "g1": bf(1 + rng.randn(1, C) * 0.1), "be1": w(1, C, fan=10), "w1": w(K, C, F, fan=K * C),
         "b1": w(1, F, fan=10), "w2": w(K, F, C, fan=K * F), "b2": w(1, C, fan=10),
         "g2": bf(1 + rng.randn(1, C) * 0.1), "be2": w(1, C, fan=10)}
    return x, g, lens, valid, p


def _port(n, a):
    conv = lambda v: np.transpose(np.asarray(v) if np.ndim(v) == 3 else np.asarray(v)[None], (2, 1, 0))  # noqa: E731
    return conv(a) if n[0] == "w" else np.asarray(a)[0] if n[0] in "bg" else np.asarray(a)


def _weights(p) -> el.EncLayerWeights:
    return el.EncLayerWeights(*[_t(_port(n, p[n])) for n in el.PARAM_NAMES], n_heads=HEADS, window=WINDOW)


def _jax(x, g, lens, p):
    spec = EncLayerSpec(channels=C, n_heads=HEADS, window=WINDOW, filter_channels=F, kernel_size=K, interpret=True)
    params = [jnp.asarray(p[n]).astype(jnp.bfloat16) for n in spec.param_names]
    out, vjp = jax.vjp(lambda x_, ps: fused_enc_layer(spec, jnp.float32(0.0), jnp.asarray(lens), x_, *ps),
                       jnp.asarray(x).astype(jnp.bfloat16), params)
    jdx, jg = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    assert out.dtype == jdx.dtype == jnp.bfloat16 and all(v.dtype == jnp.bfloat16 for v in jg)
    return _t(out), _t(jdx), {n: _t(_port(n, jg[i])) for i, n in enumerate(spec.param_names)}


@pytest.fixture(scope="module", params=[(3, 1), (17, 2), (40, 3)], ids=lambda c: f"T{c[0]}")
def case(request):
    T, seed = request.param
    x, g, lens, valid, p = _case(T, seed)
    return {"x": _t(x), "g": _t(g), "lens": torch.from_numpy(lens), "valid": torch.from_numpy(valid),
            "w": _weights(p), "jax": _jax(x, g, lens, p)}


def test_forward_bf16_matches_jax_kernel(case):
    out = case["jax"][0]
    with torch.no_grad():
        ours = el.enc_layer_reference(case["x"], case["lens"], case["w"])
        through = el.enc_layer(case["x"], case["lens"], case["w"])
    assert ours.dtype == through.dtype == torch.bfloat16
    torch.testing.assert_close(through, ours, rtol=0, atol=0)
    share, worst, _ = agreement(ours[case["valid"]], out[case["valid"]])
    assert share >= ULP_SHARE and worst <= MAX_RTOL, (share, worst)


def test_vjp_bf16_matches_jax_kernel(case):
    _, jdx, jgrads = case["jax"]
    x = case["x"].clone().requires_grad_(True)
    leaves = [t.clone().requires_grad_(True) for t in case["w"].tensors().values()]
    el.enc_layer(x, case["lens"], case["w"].with_tensors(leaves)).backward(case["g"])
    dx, grads = el.enc_layer_backward_reference(case["x"], case["lens"], case["w"], case["g"])
    assert dx.dtype == x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)
    for name, leaf in zip(el.PARAM_NAMES, leaves):
        assert leaf.grad.dtype == torch.bfloat16
        torch.testing.assert_close(leaf.grad, grads[name], rtol=0, atol=0)
    valid = case["valid"]
    _, worst, l2 = agreement(dx[valid], jdx[valid])
    assert l2 <= SUM_RTOL and worst <= MAX_RTOL, ("dx", l2, worst)
    top = max(t.float().norm().item() for t in jgrads.values())
    for name, ref in jgrads.items():
        err = (grads[name].float() - ref.float()).norm().item()
        assert err <= SUM_RTOL * max(ref.float().norm().item(), SUM_RTOL * top), (name, err)


def test_a_skipped_rounding_point_fails_against_jax():
    """The control: the dropped probabilities not rounded before P V (and
    the band's before R_v)."""
    x, _, lens, valid, p = _case(40, 3)
    out = _jax(x, np.zeros_like(x), lens, p)[0]
    w = _weights(p)
    _, xf, wf = el._operands(_t(x), w)

    def skip_probs(t):  # P's shape [B, heads, T, T]: left unrounded
        return t if t.ndim == 4 and t.shape[-1] == t.shape[-2] == x.shape[1] else round_bf16(t)

    valid = torch.from_numpy(valid)
    good = el._forward(xf, torch.from_numpy(lens), wf, 0, 0.0, round_bf16)["out"].to(torch.bfloat16)
    bad = el._forward(xf, torch.from_numpy(lens), wf, 0, 0.0, skip_probs)["out"].to(torch.bfloat16)
    good, bad = agreement(good[valid], out[valid])[2], agreement(bad[valid], out[valid])[2]
    assert good <= CONTROL_L2 < bad, (good, bad)


def test_mixed_dtypes_raise():
    x, g, lens, _, p = _case(5, 4)
    w = _weights(p)
    lens = torch.from_numpy(lens)
    with pytest.raises(ValueError, match="share one dtype"):
        el.enc_layer(_t(x).float(), lens, w)
    with pytest.raises(ValueError, match="share one dtype"):
        el.enc_layer_backward_reference(_t(x), lens, w, _t(g).float())
    mixed = w.with_tensors([t.float() if n == "rk" else t for n, t in w.tensors().items()])
    with pytest.raises(ValueError, match="share one dtype"):
        el.enc_layer_reference(_t(x), lens, mixed)


# chip_smoke.B5_SHAPES, (B, T), at the encoders' widths (C 192 in 2 heads of 96, F 768)
B5_SHAPES = ((8, 256), (1, 160), (8, 512), (3, 3), (4, 64))


@pytest.mark.parametrize("kernel_size", (1, 3, 5))
@pytest.mark.parametrize("shape", B5_SHAPES, ids=lambda s: f"B{s[0]}xT{s[1]}")
def test_bwd16_scratch_layout_keeps_tma_rules(shape, kernel_size):
    """The bf16 backward's scratch (ops/enc_layer.py:bwd16_layout), at every
    window: every base 16-byte aligned, every row pitch a multiple of 16
    bytes (TMA's rules for what it reads; the bf16 parts' rows pitch8 of
    their width, as csrc/bf16_engine.cuh's maps take them), no two parts
    overlapping, the split of the long products leaving no split empty, and
    the buffers ``return_buffers`` hands back viewed at their shapes."""
    B, T = shape
    Cw, Fw, H = 192, 768, 2
    splits = el.bwd16_splits(B, T, Fw, kernel_size)
    slices = kernel_size * Fw // 64
    per = -(-slices // splits)
    assert 1 <= splits <= slices and -(-slices // per) == splits
    for window in range(9):
        for wsum in (0, 2 * 132 * 64 * 128):
            parts, total = el.bwd16_layout(B, T, Cw, Fw, H, window, kernel_size, splits, wsum)
            assert [p.name for p in parts.values()] == [n for n, _, _ in el.BWD16_PARTS]
            end = 0
            for p in sorted(parts.values(), key=lambda q: q.offset):
                size = torch.finfo(p.dtype).bits // 8
                assert p.offset % 16 == 0 and p.offset % el.BWD16_ALIGN == 0, p
                assert p.pitch % 16 == 0 and p.pitch >= p.width * size, p
                if p.dtype == torch.bfloat16:
                    assert p.pitch == -(-p.width // 8) * 8 * 2, p
                assert p.offset >= end, (p, end)
                end = p.offset + p.nbytes
            assert end <= total
    parts, total = el.bwd16_layout(B, T, Cw, Fw, H, 4, kernel_size, splits, 0)
    scratch = torch.empty(total, dtype=torch.uint8)
    x = torch.empty(B, T, Cw, dtype=torch.bfloat16)
    w = el.EncLayerWeights(*[torch.empty(1, dtype=torch.bfloat16)] * 12, torch.empty(Fw, Cw, kernel_size),
                           *[torch.empty(1, dtype=torch.bfloat16)] * 5, n_heads=H, window=4)
    for name, want in el.backward_buffer_shapes(x, w).items():
        view = el._part_view(scratch, parts[name], want)
        assert tuple(view.shape) == want and view.dtype == parts[name].dtype, name


@pytest.mark.parametrize("p_drop", (0.0, 0.1))
def test_forward_return_buffers_are_the_recompute(case, p_drop):
    """enc_layer's return_buffers on the CPU: the plain forward's out, and
    q|k|v, the heads' output, LN1's output masked and the FFN's hidden rows
    equal to the plain backward's recompute (enc_layer_backward's
    return_buffers) and to the plain forward's own values, bit for bit, in
    the dtypes and shapes of backward_buffer_shapes (on the card the forward
    is the backward's recompute, and chip_smoke holds the two bit for bit)."""
    x, lens, w = case["x"], case["lens"], case["w"]
    seed = torch.tensor([7], dtype=torch.int64)
    out, bufs = el.enc_layer(x, lens, w, seed, p_drop, return_buffers=True)
    torch.testing.assert_close(out, el.enc_layer_reference(x, lens, w, seed, p_drop), rtol=0, atol=0)
    recomputed = el.enc_layer_backward(x, lens, w, case["g"], seed, p_drop, return_buffers=True)[2]
    rnd, xf, wf = el._operands(x, w)
    s = el._forward(xf, lens, wf, seed, p_drop, rnd)
    plain = {"qkv": round_bf16(torch.cat([s["q"], s["k"], s["v"]], dim=-1)), "att": round_bf16(s["att"] * s["valid"]),
             "x1m": round_bf16(s["x1"] * s["valid"]), "hid": s["d1m"]}
    shapes = el.backward_buffer_shapes(x, w)
    assert tuple(bufs) == tuple(recomputed) == el.FWD16_BUFFERS
    for name, buf in bufs.items():
        assert tuple(buf.shape) == shapes[name], name
        assert buf.dtype == (torch.float32 if name == "hid" else torch.bfloat16), name
        torch.testing.assert_close(buf, recomputed[name], rtol=0, atol=0)
        torch.testing.assert_close(buf.float(), plain[name], rtol=0, atol=0)


@pytest.mark.parametrize("buffers", (False, True), ids=("out", "buffers"))
@pytest.mark.parametrize("kernel_size", (1, 3, 5))
@pytest.mark.parametrize("shape", B5_SHAPES, ids=lambda s: f"B{s[0]}xT{s[1]}")
def test_fwd16_layout_keeps_tma_rules(shape, kernel_size, buffers):
    """The bf16 forward's scratch (ops/enc_layer.py:fwd16_layout), by the
    backward's rules (test_bwd16_scratch_layout_keeps_tma_rules; it has no
    part whose size depends on the window): bases 16-byte and BWD16_ALIGN
    aligned, bf16 rows pitch8 of their width, fp32 rows 16-byte multiples,
    no overlap; its recompute parts as wide as the backward's; the fp32 hid
    only for return_buffers, and the buffers return_buffers hands back
    viewed at their shapes."""
    B, T = shape
    Cw, Fw, H = 192, 768, 2
    splits = el.bwd16_splits(B, T, Fw, kernel_size)
    parts, total = el.fwd16_layout(B, T, Cw, Fw, H, 8, kernel_size, splits, buffers)
    back, _ = el.bwd16_layout(B, T, Cw, Fw, H, 8, kernel_size, splits, 0)
    assert [p.name for p in parts.values()] == [n for n, _, _ in el.FWD16_PARTS]
    end = 0
    for p in sorted(parts.values(), key=lambda q: q.offset):
        size = torch.finfo(p.dtype).bits // 8
        assert p.offset % 16 == 0 and p.offset % el.BWD16_ALIGN == 0, p
        assert p.pitch % 16 == 0 and p.pitch >= p.width * size, p
        if p.dtype == torch.bfloat16:
            assert p.pitch == -(-p.width // 8) * 8 * 2, p
        same = (p.rows, p.width, p.pitch, p.dtype) == (back[p.name].rows, back[p.name].width, back[p.name].pitch,
                                                       back[p.name].dtype)
        assert same or (p.name == "hid" and not buffers and p.nbytes == 0), p
        assert p.offset >= end, (p, end)
        end = p.offset + p.nbytes
    assert end <= total
    scratch = torch.empty(total, dtype=torch.uint8)
    x = torch.empty(B, T, Cw, dtype=torch.bfloat16)
    w = el.EncLayerWeights(*[torch.empty(1, dtype=torch.bfloat16)] * 12, torch.empty(Fw, Cw, kernel_size),
                           *[torch.empty(1, dtype=torch.bfloat16)] * 5, n_heads=H, window=8)
    if buffers:
        for name in el.FWD16_BUFFERS:
            want = el.backward_buffer_shapes(x, w)[name]
            view = el._part_view(scratch, parts[name], want)
            assert tuple(view.shape) == want and view.dtype == parts[name].dtype, name
