"""B6's bf16 mode (speech_masters_thesis_tpu_torch/ops/flow_step.py) against
the JAX package's fused_flow_step in bf16, on the CPU.

The TPU kernel's bf16 mode (dot_dtype = x's dtype) runs the ActNorm in fp32
on x upcast, rounds x1 and mt as the operands of the mix product and the
conditioner's operands as B3's bf16 mode, writes xc and out in bf16; its
VJP takes the cotangents in bf16, keeps dxc = g_xc + dx0 in fp32, rounds x1,
dxc and mt in dmt's and dx1's products, sums daln and dalb in fp32, writes
dx in bf16 and casts the gradients to the inputs' dtypes: fp32 for aln, alb
and mt (the JAX decoder passes them upcast from the bf16 parameters), bf16
for the conditioner's weights. The same numpy inputs, rounded to bf16, go
through the port's plain forward and recompute backward (directly, and
through ``flow_step``, whose CPU bf16 route is ``FlowStepFunction`` over
them) and through the JAX kernel in interpret mode at p=0, at
tests/test_torch_flow_step.py's shapes with ragged lengths.

Tolerances (tests/test_torch_bf16_wn_coupling.py's): xc and out at least
ULP_SHARE (99%) of the valid elements within one bf16 ulp of their own
magnitude and all within MAX_RTOL (2^-6) of max|ref|; dx, daln, dalb, dmt
and every conditioner weight gradient within SUM_RTOL (2^-7) relative L2,
over a norm floored at SUM_RTOL of the largest leaf's. A plain forward that
does not round x1 before the mix product moves xc's relative L2 error
against JAX above CONTROL_L2 (2^-10); the port's stays below it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from speech_masters_thesis_tpu_torch.models.glow_tts import flows
from speech_masters_thesis_tpu_torch.models.glow_tts.encoder import FlowSpecDecoder
from speech_masters_thesis_tpu_torch.ops import flow_step as fs
from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn
from speech_masters_thesis_tpu_torch.ops.basic import round_bf16, sequence_mask

from test_torch_bf16_wn_coupling import CONTROL_L2, MAX_RTOL, SUM_RTOL, ULP_SHARE, agreement
from test_torch_flow_step import B, C, DEC, HALF, L, _case, _conv, _dense_mt, _jax_flow_step
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

NAMES = ("x", "aln", "alb", "mt", "ws", "bs", "wins", "bins", "wrss", "brss", "wend", "bend")
PREFIX = ("aln", "alb", "mt")  # fp32 in both modes, holding bf16-rounded values here


def _bf(a):
    """a numpy array rounded to bf16, kept as fp32"""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16).astype(jnp.float32))


def _t16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _bf16_case(T: int, k: int, rate: int):
    """test_torch_flow_step's inputs rounded to bf16: the JAX primals (x and
    the conditioner's weights bf16, aln, alb, mt fp32 of bf16 values), the
    port's (x, lens, aln, alb, mt, weights) and bf16 cotangents."""
    lens, j, spec, (_, lens_t, _, _, _, w32) = _case(T, k, rate)
    j = jax.tree.map(_bf, j)
    primals = [jax.tree.map(lambda a: jnp.asarray(a) if n in PREFIX else jnp.asarray(a).astype(jnp.bfloat16), j[n])
               for n in NAMES]
    weights = wn.WNWeights.from_flat([t.to(torch.bfloat16) for t in w32.flat()], w32.dilations)
    port = (_t16(j["x"]), lens_t, torch.from_numpy(j["aln"][0]), torch.from_numpy(j["alb"][0]),
            torch.from_numpy(j["mt"]), weights)
    rng = np.random.RandomState(T + k + 50)
    g_xc, g_out = (_bf(rng.randn(B, T, C)) for _ in range(2))
    return lens, spec, primals, port, (g_xc, g_out)


def _jax(lens, spec, primals, cots):
    """(xc, out, {port name: gradient}) of the JAX kernel in bf16."""
    (xc, out), vjp = jax.vjp(lambda *a: _jax_flow_step(spec, lens, *a[:4], a[4:]), *primals)
    jg = dict(zip(NAMES, vjp(tuple(jnp.asarray(g).astype(jnp.bfloat16) for g in cots))))
    ref = {"dx": jg["x"], "daln": jg["aln"][0], "dalb": jg["alb"][0], "dmt": jg["mt"], "ws": _conv(jg["ws"]),
           "bs": jg["bs"][0], "wend": _conv(jg["wend"]), "bend": jg["bend"][0]}
    for i in range(L):
        ref.update({f"win{i}": _conv(jg["wins"][i]), f"bin{i}": jg["bins"][i][0],
                    f"wrs{i}": _conv(jg["wrss"][i]), f"brs{i}": jg["brss"][i][0]})
    assert xc.dtype == out.dtype == jg["x"].dtype == jnp.bfloat16
    assert all(jg[n].dtype == jnp.float32 for n in PREFIX) and jg["ws"].dtype == jnp.bfloat16
    as_torch = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32)))  # noqa: E731
    return as_torch(xc), as_torch(out), {n: as_torch(v) for n, v in ref.items()}


CASES = [(32, 5, 1), (7, 3, 2)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"T{c[0]}-k{c[1]}-r{c[2]}")
def case(request):
    lens, spec, primals, port, cots = _bf16_case(*request.param)
    valid = sequence_mask(port[1], port[0].shape[1]).bool()
    return {"port": port, "cots": tuple(_t16(g) for g in cots), "valid": valid,
            "jax": _jax(lens, spec, primals, cots)}


def test_forward_bf16_matches_jax_kernel(case):
    xc_ref, out_ref, _ = case["jax"]
    with torch.no_grad():
        ours = fs.flow_step_reference(*case["port"])
        through = fs.flow_step(*case["port"])
    valid = case["valid"]
    for name, a, b, ref in zip(("xc", "out"), ours, through, (xc_ref, out_ref)):
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        share, worst, _ = agreement(a[valid], ref[valid])
        assert share >= ULP_SHARE and worst <= MAX_RTOL, (name, share, worst)


@pytest.mark.parametrize("p_drop", (0.0, 0.05))
def test_forward_return_buffers_are_the_recompute(case, p_drop):
    """flow_step's return_buffers on the CPU: the plain forward's xc and out,
    and x_in and the skip sum equal to recomputed_buffers on xc's first half
    and to the backward's return_buffers, whose x0 is xc's first half."""
    x, lens, aln, alb, mt, w = case["port"]
    seed = torch.tensor([9], dtype=torch.int64)
    xc, out, bufs = fs.flow_step(x, lens, aln, alb, mt, w, seed, p_drop, return_buffers=True)
    xc_r, out_r = fs.flow_step_reference(x, lens, aln, alb, mt, w, seed, p_drop)
    torch.testing.assert_close(xc, xc_r, rtol=0, atol=0)
    torch.testing.assert_close(out, out_r, rtol=0, atol=0)
    plain = wn.recomputed_buffers(xc[..., :HALF], lens, w, seed, p_drop)
    recomputed = fs.flow_step_backward(x, lens, aln, alb, mt, w, *case["cots"], seed, p_drop, return_buffers=True)[5]
    assert set(bufs) == set(plain) == {"xin", "skip"} and set(recomputed) == {"xin", "skip", "x0"}
    torch.testing.assert_close(recomputed["x0"], xc[..., :HALF], rtol=0, atol=0)
    for name in bufs:
        torch.testing.assert_close(bufs[name], plain[name], rtol=0, atol=0)
        torch.testing.assert_close(bufs[name], recomputed[name], rtol=0, atol=0)


def test_vjp_bf16_matches_jax_kernel(case):
    """dx, daln, dalb, dmt and every conditioner weight gradient, through
    flow_step's autograd Function (the plain backward on the CPU) and the
    plain backward, against jax.vjp; their dtypes are the TPU kernel's."""
    _, _, ref = case["jax"]
    x, lens, aln, alb, mt, w = case["port"]
    leaves = [t.clone().requires_grad_(True) for t in (x, aln, alb, mt, *w.flat())]
    xc, out = fs.flow_step(leaves[0], lens, *leaves[1:4], wn.WNWeights.from_flat(leaves[4:], w.dilations))
    torch.autograd.backward((xc, out), case["cots"])
    dx, daln, dalb, dmt, grads = fs.flow_step_backward_reference(x, lens, aln, alb, mt, w, *case["cots"])
    ours = {"dx": dx, "daln": daln, "dalb": dalb, "dmt": dmt, **grads.tensors()}
    assert dx.dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in (daln, dalb, dmt))
    assert all(t.dtype == torch.bfloat16 for t in grads.flat())
    for got, want in zip([leaf.grad for leaf in leaves], [dx, daln, dalb, dmt, *grads.flat()]):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    valid = case["valid"]
    _, worst, l2 = agreement(dx[valid], ref["dx"][valid])
    assert l2 <= SUM_RTOL and worst <= MAX_RTOL, ("dx", l2, worst)
    top = max(t.norm().item() for n, t in ref.items() if n != "dx")
    for name, r in ref.items():
        if name == "dx":
            continue
        err = (ours[name].float() - r).norm().item()
        assert err <= SUM_RTOL * max(r.norm().item(), SUM_RTOL * top), (name, err, r.norm().item())


def test_an_unrounded_mix_operand_fails_against_jax():
    """The control: x1 not rounded before the mix product. The port's plain
    xc lies within CONTROL_L2 of JAX's; the variant's does not."""
    lens, spec, primals, (x, lens_t, aln, alb, mt, _), cots = _bf16_case(32, 5, 1)
    xc_ref = _jax(lens, spec, primals, cots)[0]
    valid = sequence_mask(lens_t, 32).bool()
    xf = x.float()
    _, x1, good = fs._prefix(xf, lens_t, aln, alb, mt, round_bf16)
    bad = x1 @ mt
    good_l2 = agreement(good.to(torch.bfloat16)[valid], xc_ref[valid])[2]
    bad_l2 = agreement(bad.to(torch.bfloat16)[valid], xc_ref[valid])[2]
    assert good_l2 <= CONTROL_L2 < bad_l2, (good_l2, bad_l2)


def test_prefix_reaches_the_kernel_fp32_of_the_bf16_parameters(monkeypatch):
    """On the decoder's B6 route under a bf16 compute copy (the bf16 train
    step's functional_call), aln, alb and mt reach flow_step as fp32 tensors
    holding the bf16 parameters' values, mt built from the rounded weight
    (JAX's dense_matrix_t(jnp.float32) of the bf16 weight), and x and the
    conditioner's weights as bf16; the fp32 masters' own values differ, so
    a route that fed them past the compute copy would fail here."""
    torch.manual_seed(3)
    dec = FlowSpecDecoder(in_channels=HALF, fused=True, fused_flow_step=True, **DEC)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.1 * torch.randn_like(p))
        for inv in dec.flows[1::3]:
            inv.weight.copy_(torch.linalg.qr(torch.randn(4, 4))[0])
    masters = dict(dec.named_parameters())
    compute = {n: p.to(torch.bfloat16) for n, p in masters.items()}
    seen, inner = [], flows.flow_step

    def recording(x, lens, aln, alb, mt, w, seed, p):
        seen.append((x, aln, alb, mt, w))
        return inner(x, lens, aln, alb, mt, w, seed, p)
    monkeypatch.setattr(flows, "flow_step", recording)
    lens = torch.tensor([32, 22], dtype=torch.int32)
    mask = sequence_mask(lens, 32)[..., None].to(torch.bfloat16)
    spect = (torch.randn(B, 32, HALF) * mask).to(torch.bfloat16)
    z, logdet = functional_call(dec, compute, (spect, mask))
    assert len(seen) == DEC["n_blocks"] and z.dtype == torch.bfloat16 and logdet.dtype == torch.float32
    for i, (x, aln, alb, mt, w) in enumerate(seen):
        assert x.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in w.flat())
        for name, t in (("logs", aln), ("bias", alb)):
            want = compute[f"flows.{3 * i}.{name}"].view(-1)
            assert t.dtype == torch.float32 and torch.equal(t, want.float()), name
            assert torch.equal(t, t.to(torch.bfloat16).float())
            assert not torch.equal(t, masters[f"flows.{3 * i}.{name}"].view(-1))
        weight = compute[f"flows.{3 * i + 1}.weight"]
        assert mt.dtype == torch.float32 and torch.equal(mt, mt.to(torch.bfloat16).float())
        np.testing.assert_array_equal(mt.detach().numpy(), _dense_mt(weight.detach().float().numpy(), C))
        assert not torch.equal(mt, flows.InvConvNear.dense_matrix_t(dec.flows[3 * i + 1]))


def test_mixed_dtypes_raise():
    _, _, _, (x, lens, aln, alb, mt, w), _ = _bf16_case(7, 3, 2)
    with pytest.raises(ValueError, match="must be torch.float32"):
        fs.flow_step(x, lens, aln.to(torch.bfloat16), alb, mt, w)
    with pytest.raises(ValueError, match="share one dtype"):
        fs.flow_step(x.float(), lens, aln, alb, mt, w)
    with pytest.raises(ValueError, match="cotangent"):
        fs.flow_step_backward_reference(x, lens, aln, alb, mt, w, x.float(), x)
