"""B3's bf16 mode (speech_masters_thesis_tpu_torch/ops/wn_coupling.py) against
the JAX package's fused_wn_coupling in bf16, on the CPU.

The TPU kernel's bf16 mode (dot_dtype = x0's dtype, ``_dot``) rounds each
product's operands to bf16 and sums in fp32, the rest fp32; its VJP takes
the cotangent in bf16 and casts every weight gradient (an fp32 sum) to the
parameter's dtype. The same numpy weights, rounded to bf16, go through the
port's plain forward and recompute backward (directly, and through
``wn_coupling``, whose CPU bf16 route is ``WNCouplingFunction`` over them) and
through the JAX kernel in interpret mode at p=0, at ragged lengths.

Tolerances (the CPU side of chip_smoke.py's bf16 B3 phase): the forward at
least ULP_SHARE (99%) of the valid elements within one bf16 ulp of their own
magnitude and all within MAX_RTOL (2^-6) of max|ref|; dx0 and every weight
gradient within SUM_RTOL (2^-7) relative L2, over a norm floored at SUM_RTOL
of the largest leaf's. A plain version that skips one of the TPU kernel's
rounding points (layer 0's gate output before the res/skip product) moves
the forward's relative L2 error against JAX from 0 (the plain version is
bit-equal at these widths, whose sums are exact) to 3.6e-3: CONTROL_L2
(2^-10) lies between.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.ops.pallas.wn_coupling import WNSpec, fused_wn_coupling
from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn
from speech_masters_thesis_tpu_torch.ops.basic import round_bf16
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ULP_SHARE = 0.99
MAX_RTOL = 2.0 ** -6
SUM_RTOL = 2.0 ** -7
CONTROL_L2 = 2.0 ** -10
HALF, H, C, K = 6, 8, 12, 5


def agreement(ours: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(share within one bf16 ulp of ref's own magnitude, max error / max|ref|, relative L2)."""
    ours, ref = ours.float(), ref.float()
    _, e = torch.frexp(ref)
    ulp = torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), e - 8))
    err = (ours - ref).abs()
    return ((err <= ulp).float().mean().item(), (err.max() / ref.abs().max()).item(),
            (err.norm() / ref.norm()).item())


def _case(T, n_layers, seed):
    """bf16 x0 (masked), cotangent g, lens and JAX-layout weights, all bf16-exact."""
    rng = np.random.RandomState(seed)
    B = 2
    lens = np.array([T, max(1, T // 2 + 1)], np.int32)
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None]
    bf = lambda a: np.asarray(jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16))  # noqa: E731
    x0 = bf(rng.randn(B, T, HALF) * valid)
    g = bf(rng.randn(B, T, C))
    w = lambda *shape: bf(rng.randn(*shape) / np.sqrt(shape[-2] if len(shape) > 1 else 10))  # noqa: E731
    rs = [2 * H if i < n_layers - 1 else H for i in range(n_layers)]
    jw = {"ws": w(HALF, H), "bs": w(1, H), "wins": tuple(w(K, H, 2 * H) for _ in range(n_layers)),
          "bins": tuple(w(1, 2 * H) for _ in range(n_layers)), "wrss": tuple(w(H, r) for r in rs),
          "brss": tuple(w(1, r) for r in rs), "wend": w(H, C), "bend": w(1, C)}
    return x0, g, lens, valid[..., 0], jw


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)


def _conv(a):
    return np.transpose(np.asarray(a), (2, 1, 0))  # [k, in, out] -> [out, in, k]


def _port_weights(jw, n_layers) -> wn.WNWeights:
    return wn.WNWeights(
        ws=_t(_conv(jw["ws"][None])), bs=_t(jw["bs"][0]), win=tuple(_t(_conv(a)) for a in jw["wins"]),
        bin=tuple(_t(b[0]) for b in jw["bins"]), wrs=tuple(_t(_conv(a[None])) for a in jw["wrss"]),
        brs=tuple(_t(b[0]) for b in jw["brss"]), wend=_t(_conv(jw["wend"][None])), bend=_t(jw["bend"][0]),
        dilations=tuple(2 ** i for i in range(n_layers)))


def _jax(x0, g, lens, jw, n_layers):
    """(out, dx0, {port name: gradient}) of the JAX kernel in bf16."""
    spec = WNSpec(half=HALF, hidden=H, out_channels=C, kernel_size=K, dilation_rate=2, n_layers=n_layers,
                  p_drop=0.0, interpret=True)
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jw)

    def f(x0_, p):
        return fused_wn_coupling(spec, jnp.float32(0.0), jnp.asarray(lens), x0_, p["ws"], p["bs"], p["wins"],
                                 p["bins"], p["wrss"], p["brss"], p["wend"], p["bend"])

    out, vjp = jax.vjp(f, jnp.asarray(x0).astype(jnp.bfloat16), params)
    jdx, jg = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    ref = {"ws": _conv(jg["ws"][None]), "bs": np.asarray(jg["bs"])[0], "wend": _conv(jg["wend"][None]),
           "bend": np.asarray(jg["bend"])[0]}
    for i in range(n_layers):
        ref.update({f"win{i}": _conv(jg["wins"][i]), f"bin{i}": np.asarray(jg["bins"][i])[0],
                    f"wrs{i}": _conv(jg["wrss"][i][None]), f"brs{i}": np.asarray(jg["brss"][i])[0]})
    assert out.dtype == jdx.dtype == jnp.bfloat16 and all(np.asarray(v).dtype == jnp.bfloat16 for v in ref.values())
    return _t(out), _t(jdx), {n: _t(v) for n, v in ref.items()}


CASES = [(7, 2, 1), (33, 4, 2), (130, 3, 3)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"T{c[0]}-L{c[1]}")
def case(request):
    T, n_layers, seed = request.param
    x0, g, lens, valid, jw = _case(T, n_layers, seed)
    return {"x0": _t(x0), "g": _t(g), "lens": torch.from_numpy(lens), "valid": torch.from_numpy(valid),
            "w": _port_weights(jw, n_layers), "jax": _jax(x0, g, lens, jw, n_layers)}


def test_forward_bf16_matches_jax_kernel(case):
    out, _, _ = case["jax"]
    with torch.no_grad():
        ours = wn.wn_coupling_reference(case["x0"], case["lens"], case["w"])
        through = wn.wn_coupling(case["x0"], case["lens"], case["w"])
    assert ours.dtype == through.dtype == torch.bfloat16
    torch.testing.assert_close(through, ours, rtol=0, atol=0)
    share, worst, _ = agreement(ours[case["valid"]], out[case["valid"]])
    assert share >= ULP_SHARE and worst <= MAX_RTOL, (share, worst)


def test_vjp_bf16_matches_jax_kernel(case):
    """dx0 and every weight gradient, through wn_coupling's autograd Function
    (the plain backward on the CPU) and the plain backward, against jax.vjp."""
    _, jdx, jgrads = case["jax"]
    x0 = case["x0"].clone().requires_grad_(True)
    leaves = [t.clone().requires_grad_(True) for t in case["w"].flat()]
    out = wn.wn_coupling(x0, case["lens"], wn.WNWeights.from_flat(leaves, case["w"].dilations))
    out.backward(case["g"])
    dx0, grads = wn.wn_coupling_backward_reference(case["x0"], case["lens"], case["w"], case["g"])
    assert dx0.dtype == x0.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x0.grad, dx0, rtol=0, atol=0)
    named = grads.tensors()
    for name, leaf in zip(named, wn.WNWeights.from_flat(leaves, case["w"].dilations).tensors().values()):
        assert leaf.grad.dtype == torch.bfloat16
        torch.testing.assert_close(leaf.grad, named[name], rtol=0, atol=0)
    valid = case["valid"]
    _, worst, l2 = agreement(dx0[valid], jdx[valid])
    assert l2 <= SUM_RTOL and worst <= MAX_RTOL, ("dx0", l2, worst)
    top = max(t.float().norm().item() for t in jgrads.values())
    for name, ref in jgrads.items():
        err = (named[name].float() - ref.float()).norm().item()
        assert err <= SUM_RTOL * max(ref.float().norm().item(), SUM_RTOL * top), (name, err)


def test_a_skipped_rounding_point_fails_against_jax():
    """The control: layer 0's gate output not rounded before its res/skip
    product. The port's plain forward stays within CONTROL_L2 of JAX's
    output; the variant does not."""
    T, n_layers, seed = 130, 3, 3
    x0, _, lens, valid, jw = _case(T, n_layers, seed)
    out, _, _ = _jax(x0, np.zeros((2, T, C), np.float32), lens, jw, n_layers)
    w = _port_weights(jw, n_layers)
    calls = []

    def skip_gate_0(t):  # _recompute's fifth rounding: layer 0's acts
        calls.append(t)
        return t if len(calls) == 5 else round_bf16(t)

    def forward(rnd):
        _, xf, wf = wn._operands(_t(x0), w)
        v, _, _, _, skip = wn._recompute(xf, torch.from_numpy(lens), wf, 0, 0.0, rnd)
        return wn.pointwise(rnd(skip * v), rnd(wf.wend), wf.bend).to(torch.bfloat16)

    valid = torch.from_numpy(valid)
    good = agreement(forward(round_bf16)[valid], out[valid])[2]
    bad = agreement(forward(skip_gate_0)[valid], out[valid])[2]
    assert calls[4].shape[-1] == H  # the skipped operand is the gate output
    assert good <= CONTROL_L2 < bad, (good, bad)


def test_mixed_dtypes_raise():
    x0, g, lens, _, jw = _case(7, 2, 1)
    w = _port_weights(jw, 2)
    lens = torch.from_numpy(lens)
    with pytest.raises(ValueError, match="share one dtype"):
        wn.wn_coupling(_t(x0).float(), lens, w)
    with pytest.raises(ValueError, match="share one dtype"):
        wn.wn_coupling_backward_reference(_t(x0), lens, w, _t(g).float())
    w32 = wn.WNWeights.from_flat([t if i else t.float() for i, t in enumerate(w.flat())], w.dilations)
    with pytest.raises(ValueError, match="share one dtype"):
        wn.wn_coupling_reference(_t(x0), lens, w32)


@pytest.mark.parametrize("p_drop", (0.0, 0.05))
def test_forward_return_buffers_are_the_recompute(case, p_drop):
    """wn_coupling's return_buffers on the CPU: the plain forward's out, and
    x_in and the skip sum equal to recomputed_buffers and to the backward's
    return_buffers (on the card the forward is the backward's recompute,
    and chip_smoke holds the two bit for bit)."""
    x0, lens, w = case["x0"], case["lens"], case["w"]
    seed = torch.tensor([7], dtype=torch.int64)
    out, bufs = wn.wn_coupling(x0, lens, w, seed, p_drop, return_buffers=True)
    torch.testing.assert_close(out, wn.wn_coupling_reference(x0, lens, w, seed, p_drop), rtol=0, atol=0)
    plain = wn.recomputed_buffers(x0, lens, w, seed, p_drop)
    recomputed = wn.wn_coupling_backward(x0, lens, w, case["g"], seed, p_drop, return_buffers=True)[2]
    assert set(bufs) == set(plain) == set(recomputed) == {"xin", "skip"}
    for name in bufs:
        torch.testing.assert_close(bufs[name], plain[name], rtol=0, atol=0)
        torch.testing.assert_close(bufs[name], recomputed[name], rtol=0, atol=0)
    assert bufs["xin"].shape == (len(w.win), *x0.shape[:2], 2 * H) and bufs["skip"].shape == (*x0.shape[:2], H)


# the bf16 scratch (csrc/wn_coupling_bf16.cu): Glow's width at (8, 384) and chip_smoke's
# B3_OTHER_SHAPES, odd widths included, (B, T, half, H, c_out, n_layers, kernel_size)
LAYOUT_SHAPES = ((8, 384, 80, 192, 160, 4, 5), (3, 7, 80, 192, 160, 4, 5), (3, 64, 80, 192, 160, 4, 3),
                 (3, 64, 10, 30, 20, 3, 5), (2, 48, 6, 9, 12, 2, 1))


@pytest.mark.parametrize("flow", (False, True), ids=("b3", "b6"))
@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd16_layout_follows_tma_rules(shape, flow):
    """Every part of the one allocation starts on a 16-byte boundary; every
    part TMA reads has rows a multiple of 16 bytes apart that hold its
    channels; no two parts overlap; B6's parts are empty for B3."""
    B, T, half, H, c_out, L, k = shape
    layout = wn.bwd16_layout(B, T, half, H, c_out, L, k, flow, wsum_floats=12345)
    assert tuple(layout) == wn.BWD16_PARTS
    channels = {"x0": half, "g": c_out, "h": H, "acts": H, "skip": H, "dskip": H, "dh": H, "dxin": 2 * H,
                "w_s": half, "w_s_t": H, "w_end_t": c_out, "w_in": H, "w_in_t": 2 * H, "w_rs": H,
                "w_rs_t": 64 * -(-H // 64) + H, "x1": c_out, "dxc": c_out, "mt_t": c_out, "mt": c_out}
    spans = []
    for name, part in layout.items():
        assert part.offset % 16 == 0 and part.offset % wn.BWD16_ALIGN == 0, name
        if part.tma and part.nbytes:
            row = part.shape[-1] * part.dtype.itemsize
            assert part.dtype == torch.bfloat16 and row % 16 == 0, (name, part.shape)
            assert channels[name] <= part.shape[-1] < channels[name] + 8, (name, part.shape)
        if name in ("x1", "dxc", "mt_t", "mt"):
            assert (part.nbytes > 0) == flow, name
        spans.append((part.offset, part.offset + part.nbytes, name))
    spans.sort()
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start, (a, b)
    assert layout["xin"].shape == (L, B, T, 2 * H) and layout["xin"].dtype == torch.float32
    assert layout["wsum_part"].nbytes == 4 * 12345
    assert layout["w_in"].shape[1] == 64 * -(-H // 32)  # the gate's rows: 32 tanh, then 32 sigmoid a group


@pytest.mark.parametrize("buffers", (False, True), ids=("out", "buffers"))
@pytest.mark.parametrize("flow", (False, True), ids=("b3", "b6"))
@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fwd16_layout_follows_tma_rules(shape, flow, buffers):
    """The bf16 forward's scratch, by test_bwd16_layout_follows_tma_rules'
    rules; B6's parts empty for B3; x0 packed for B3, and for B6 only where
    xc's rows (C bf16) are not 16 bytes apart, so TMA cannot read them in
    place; h in two planes, acts in one; x_in only for return_buffers."""
    B, T, half, H, c_out, L, k = shape
    layout = wn.fwd16_layout(B, T, half, H, c_out, L, k, flow, buffers)
    assert tuple(layout) == wn.FWD16_PARTS
    channels = {"x0": half, "h": H, "acts": H, "skip": H, "w_s": half, "w_in": H, "w_rs": H, "w_end": H,
                "x1": c_out, "mt_t": c_out}
    spans = []
    for name, part in layout.items():
        assert part.offset % 16 == 0 and part.offset % wn.BWD16_ALIGN == 0, name
        if part.tma and part.nbytes:
            row = part.shape[-1] * part.dtype.itemsize
            assert part.dtype == torch.bfloat16 and row % 16 == 0, (name, part.shape)
            assert channels[name] <= part.shape[-1] < channels[name] + 8, (name, part.shape)
        if name in ("x1", "mt_t"):
            assert (part.nbytes > 0) == flow, name
        spans.append((part.offset, part.offset + part.nbytes, name))
    spans.sort()
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start, (a, b)
    assert (layout["x0"].nbytes > 0) == (not flow or (2 * c_out) % 16 != 0)
    assert layout["h"].shape[0] == min(L, 2) and layout["acts"].shape == (B, T, wn.pitch8(H))
    assert layout["xin"].shape == ((L, B, T, 2 * H) if buffers else (0,)) and layout["xin"].dtype == torch.float32
    assert layout["w_in"].shape == (L * k, 64 * -(-H // 32), wn.pitch8(H))  # the backward's gate row order
    assert layout["w_end"].shape == (1, c_out, wn.pitch8(H)) and layout["mt_t"].shape[1:2] in ((c_out,), ())
