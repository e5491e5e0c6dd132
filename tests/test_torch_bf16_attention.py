"""B2's bf16 mode (speech_masters_thesis_tpu_torch/ops/attention.py) against
the JAX package's fused_attention in bf16, on the CPU.

The TPU kernel's bf16 mode (dot_dtype = q's dtype) computes S from bf16 q
and k with fp32 sums, the masked softmax in fp32, rounds P keep to bf16
after normalisation before P V and dV, takes g in q's dtype, forms
dS = P (dP - rowsum(dP P)) scale in fp32 and rounds it before dQ and dK;
its outputs are in q's dtype. The same numpy inputs, rounded to bf16, go
through the port's plain forward and backward (directly, and through
``fused_attention``, whose CPU bf16 route is ``FusedAttentionFunction``
over them) and through the JAX kernel in interpret mode at p=0, B=2, H=2,
D=32, T in {7, 32}, ragged lengths. At p > 0 (where the JAX kernel draws on
the TPU's PRNG, which the CPU cannot run) the bf16 plain version holds the
fp32 plain version's law on the same hash masks.

Tolerances (tests/test_torch_bf16_wn_coupling.py's): o at least ULP_SHARE
(99%) of the elements within one bf16 ulp of their own magnitude and all
within MAX_RTOL (2^-6) of max|ref|; dq, dk and dv within SUM_RTOL (2^-7)
relative L2 and MAX_RTOL of max|ref|. A plain forward that multiplies V
by unrounded probabilities, or a backward that forms delta from o (the
fp32 kernel's rowsum(g o)), moves its relative L2 error against JAX above
CONTROL_L2 (2^-10); the port's stays below it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_masters_thesis_tpu.ops.pallas.attention import SmallTAttnSpec, fused_attention as jax_attention
from speech_masters_thesis_tpu_torch.ops import attention as att

from test_torch_bf16_wn_coupling import CONTROL_L2, MAX_RTOL, SUM_RTOL, ULP_SHARE, agreement
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

B, H, D = 2, 2, 32
SCALE = 1.0 / np.sqrt(D)
P_DROP = 0.1


def _case(T: int):
    """bf16-exact q, k, v, g [B, T, H, D] (fp32 numpy) and ragged lengths."""
    rng = np.random.RandomState(T)
    bf = lambda a: np.asarray(jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q, k, v, g = (bf(rng.randn(B, T, H, D)) for _ in range(4))
    lens = np.array([T, max(1, T // 2 + 1)], np.int32)
    return q, k, v, g, lens


def _jax(q, k, v, g, lens):
    """(o, dq, dk, dv) of the JAX kernel in bf16, as fp32 torch tensors."""
    spec = SmallTAttnSpec(n_heads=H, d_head=D, scale=SCALE, p_drop=0.0, interpret=True)
    lens_f32 = jax.lax.bitcast_convert_type(jnp.asarray(lens), jnp.float32)
    o, vjp = jax.vjp(lambda *a: jax_attention(spec, jnp.float32(0.0), lens_f32, *a),
                     *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    grads = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    assert o.dtype == jnp.bfloat16 and all(t.dtype == jnp.bfloat16 for t in grads)
    return tuple(torch.from_numpy(np.asarray(t.astype(jnp.float32))) for t in (o, *grads))


def _t16(a) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.fixture(scope="module", params=[7, 32], ids=lambda t: f"T{t}")
def case(request):
    q, k, v, g, lens = _case(request.param)
    return {"port": tuple(_t16(a) for a in (q, k, v)), "g": _t16(g), "lens": torch.from_numpy(lens),
            "jax": _jax(q, k, v, g, lens)}


def test_forward_bf16_matches_jax_kernel(case):
    o_ref = case["jax"][0]
    seed = torch.zeros(1, dtype=torch.int64)
    with torch.no_grad():
        ours = att.attention_reference(*case["port"], case["lens"], seed, SCALE)
        through = att.fused_attention(*case["port"], case["lens"], seed, SCALE)
    assert ours.dtype == through.dtype == torch.bfloat16
    torch.testing.assert_close(through, ours, rtol=0, atol=0)
    share, worst, _ = agreement(ours, o_ref)
    assert share >= ULP_SHARE and worst <= MAX_RTOL, (share, worst)


def test_vjp_bf16_matches_jax_kernel(case):
    """dq, dk, dv through fused_attention's autograd Function (the plain
    backward on the CPU) and the plain backward, against jax.vjp."""
    seed = torch.zeros(1, dtype=torch.int64)
    leaves = [t.clone().requires_grad_(True) for t in case["port"]]
    att.fused_attention(*leaves, case["lens"], seed, SCALE).backward(case["g"])
    plain = att.attention_backward_reference(*case["port"], case["lens"], seed, case["g"], SCALE)
    for name, leaf, ours, ref in zip(("dq", "dk", "dv"), leaves, plain, case["jax"][1:]):
        assert leaf.grad.dtype == ours.dtype == torch.bfloat16
        torch.testing.assert_close(leaf.grad, ours, rtol=0, atol=0)
        _, worst, l2 = agreement(ours, ref)
        assert l2 <= SUM_RTOL and worst <= MAX_RTOL, (name, l2, worst)


@pytest.mark.parametrize("T", [7, 32])
def test_dropout_bf16_keeps_the_fp32_law(T):
    """At p=0.1 the bf16 plain forward and backward against the fp32 plain
    versions on the same bf16-exact inputs and hash masks (SUM_RTOL relative
    L2); the same call at p=0 is far from them (the masks are applied)."""
    q, k, v, g, lens = _case(T)
    lens = torch.from_numpy(lens)
    seed = torch.tensor([1234], dtype=torch.int64)
    f32 = [torch.from_numpy(a) for a in (q, k, v)]
    b16 = [_t16(a) for a in (q, k, v)]
    want = [att.attention_reference(*f32, lens, seed, SCALE, P_DROP),
            *att.attention_backward_reference(*f32, lens, seed, torch.from_numpy(g), SCALE, P_DROP)]
    got = [att.attention_reference(*b16, lens, seed, SCALE, P_DROP),
           *att.attention_backward_reference(*b16, lens, seed, _t16(g), SCALE, P_DROP)]
    undropped = att.attention_reference(*b16, lens, seed, SCALE, 0.0)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
        l2 = agreement(a, r)[2]
        assert a.dtype == torch.bfloat16 and l2 <= SUM_RTOL, (name, l2)
    assert agreement(undropped, want[0])[2] > 8 * SUM_RTOL


def test_skipped_rounding_points_fail_against_jax():
    """The controls: P V with unrounded probabilities, and the backward's
    delta from o (rowsum(g o)) instead of rowsum(dp p)."""
    q, k, v, g, lens = _case(32)
    o_ref, dq_ref, _, _ = _jax(q, k, v, g, lens)
    qf, kf, vf, gf = (torch.from_numpy(a) for a in (q, k, v, g))
    lens = torch.from_numpy(lens)
    p = att._probs(qf, kf, lens, SCALE)
    unrounded = torch.einsum("bhqk,bkhd->bqhd", p, att._masked_values(vf, lens)).to(torch.bfloat16)
    ours = att.attention_reference(*(_t16(a) for a in (q, k, v)), lens, 0, SCALE)
    assert agreement(ours, o_ref)[2] <= CONTROL_L2 < agreement(unrounded, o_ref)[2]
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, att._masked_values(vf, lens))
    delta_o = (gf * ours.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta_o) * SCALE).to(torch.bfloat16).float()
    dq_o = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dq = att.attention_backward_reference(*(_t16(a) for a in (q, k, v)), lens, 0, _t16(g), SCALE)[0]
    assert agreement(dq, dq_ref)[2] <= CONTROL_L2 < agreement(dq_o, dq_ref)[2]


def test_mixed_dtypes_raise():
    q, k, v, g, lens = _case(7)
    lens, seed = torch.from_numpy(lens), torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="share one dtype"):
        att.fused_attention(_t16(q), _t16(k), torch.from_numpy(v), lens, seed, SCALE)
    with pytest.raises(ValueError, match="share one dtype"):
        att.attention_backward_reference(_t16(q), _t16(k), _t16(v), lens, seed, torch.from_numpy(g), SCALE)


# ---------------------------------------------------------------------------
# the host side of the bf16 kernels (csrc/attention_bf16.cu): the wrapper's
# stride check on the LM's packed views
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 2, 3, 63, 64, 65, 257, 258, 513, 1024])
def test_check_call_takes_packed_views(monkeypatch, T):
    """The LM's q, k, v (views of one packed [B, T, 3 H D] projection) pass
    the kernels' stride check with ld = 3 H D at any T, T = 1 included
    (where torch gives the time dimension a stride of its own); a view that
    is not rows ld apart still raises."""
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    packed = torch.zeros(3, T, 3 * H * D, dtype=torch.bfloat16)
    q, k, v = (t.view(3, T, H, D) for t in packed.split(H * D, dim=-1))
    lens, seed = torch.full((3,), T, dtype=torch.int32), torch.zeros(1, dtype=torch.int64)
    assert att._check_call(q, k, v, lens, seed) == 3 * H * D
    strided = torch.zeros(3, H, T + 1, D, dtype=torch.bfloat16).transpose(1, 2)[:, :T]
    with pytest.raises(ValueError, match="strides"):
        att._check_call(q, k, strided, lens, seed)
