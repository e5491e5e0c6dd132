"""B5, the Glow-TTS text-encoder layer, as its kernels compute it
(csrc/enc_layer_{fwd,bwd}.cu through csrc/enc_layer_common.cuh): every
product on the tensor cores in 3xTF32 (csrc/conv_mma.cuh), emulated on the
CPU by ops/tf32.py in the kernels' k-order, each conv tap a shifted k-slice
(tap-major, each tap's channels in whole k-steps), each k-step's MMAs added
to the accumulators in fp32 (``rz_steps=1``): q|k|v as one product against
the packed [3C, C] weight, W_o, the FFN's two k=3 convs, and in the
backward their transposes (W_2's and W_1's tap-flipped), doh = dy W_o and dx
as one product of depth 3C against the packed weight; the weight gradients
of one group a frame (W_q, W_k, W_v, W_o, each tap of W_1 and W_2) over the
frames as the MMAs' k in fixed-order slices, each slice's register added
into its partial every 1,024 frames (``rz_steps=128``, wgrad_mma.cuh). The
attention kernels, the LayerNorms, the head-grouped R_k / R_v gradients and
the LayerNorm gains stay fp32 on the CUDA cores: plain fp32 here.

* p=0, against JAX's ``fused_enc_layer`` and its VJP (the Pallas kernel in
  interpret mode, as tests/test_torch_glow_train.py runs it): the output
  within chip_smoke's B5_RTOL, dx within DX_RTOL and every weight gradient
  within WGRAD_RTOL (floored at GRAD_FLOOR of the largest leaf's, as
  chip_smoke.leaf_report), with 3 TF32 products.
* p=0.1, against the plain versions in fp64 with the port's hash masks
  (the JAX kernel draws the TPU's own bits), the backward at the
  emulation's own relu decisions: the same tolerances.
* A single TF32 product per product instead of 3, beside it: the output and
  dx miss their tolerances (printed with ``pytest -s``; PERF.md records
  them).

B=2, C=192 (the LayerNorm tile's whole row) in 2 heads of 96, window 4,
k=3, T and the FFN width small.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import B5_RTOL, DX_RTOL, GRAD_FLOOR, WGRAD_RTOL
from speech_masters_thesis_tpu.ops.pallas.enc_layer import EncLayerSpec, fused_enc_layer
from speech_masters_thesis_tpu_torch.ops import enc_layer as el

from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from test_torch_wn_tf32 import _conv, _one, _wgrad

C, HEADS, WINDOW, K = 192, 2, 4, 3
N_SPLIT = 2  # slices of the frames in the weight-gradient emulation
SEED = 31
# (T, FFN width, p): the JAX kernel at p=0, the fp64 plain version at p=0.1
CASES = [(17, 768, 0.0), (24, 256, 0.0), (17, 768, 0.1), (24, 256, 0.1)]
IDS = [f"T{T}-F{Fc}-p{p}" for T, Fc, p in CASES]


def _ln(z, gamma, beta, eps):
    """conv_rows.cuh's LN epilogue: flax's statistics; (out, zhat, 1/std)."""
    mean = z.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp((z * z).mean(dim=-1, keepdim=True) - mean * mean, min=0.0) + eps)
    zhat = (z - mean) * inv
    return zhat * gamma + beta, zhat, inv


def _ln_bwd(dx, zhat, inv, gamma):
    """conv_rows.cuh's LN_BWD epilogue: the LayerNorm input's cotangent."""
    dy = dx * gamma
    return inv * (dy - dy.mean(dim=-1, keepdim=True) - zhat * (dy * zhat).mean(dim=-1, keepdim=True))


def _qkv_weight(w: el.EncLayerWeights) -> torch.Tensor:
    """The packed [3C, C] weight of W_q, W_k and W_v."""
    return torch.cat([w.wq, w.wk, w.wv])[:, :, 0]


def kernel_forward(x, lens, w: el.EncLayerWeights, passes: int = 3, seed=0, p_drop: float = 0.0) -> dict:
    """forward_chain's launches and epilogues, keeping the recompute's buffers."""
    T, Fc = x.shape[1], w.w1.shape[0]
    drop = p_drop > 0.0
    keep = lambda site, width: el.dropout_keep(seed, lens, T, width, site, p_drop) if drop else 1.0  # noqa: E731
    valid = (torch.arange(T)[None, :] < lens[:, None]).to(x.dtype)[..., None]
    s = {"valid": valid}
    s["qkv"] = _conv(x, _qkv_weight(w).t()[None], 1, passes, valid) + torch.cat([w.bq, w.bk, w.bv])
    q, k, v = s["qkv"].split(C, dim=-1)
    s["p"] = el.attention_probs(q, k, valid, w.rk, w.n_heads, w.window)
    s["pd"] = s["p"] * el.attention_keep(seed, lens, w.n_heads, T, p_drop) if drop else s["p"]
    s["att"] = el._merge(s["pd"] @ el._heads(v, w.n_heads) + el.band_extract(s["pd"], w.window) @ w.rv)
    y = _conv(s["att"], _one(w.wo), 1, passes) + w.bo
    s["x1"], s["zhat1"], s["inv1"] = _ln(y * keep(el.SITE_ATTN_Y, C) + x * valid, w.g1, w.be1, w.eps)
    s["c1"] = _conv(s["x1"], w.w1.permute(2, 1, 0), 1, passes, valid) + w.b1
    s["hid"] = torch.relu(s["c1"]) * keep(el.SITE_FFN_MID, Fc) * valid
    c2 = _conv(s["hid"], w.w2.permute(2, 1, 0), 1, passes, valid) + w.b2
    s["out"], s["zhat2"], s["inv2"] = _ln(c2 * valid * keep(el.SITE_FFN_Y, C) + s["x1"], w.g2, w.be2, w.eps)
    return s


def kernel_backward(x, lens, w: el.EncLayerWeights, g, passes: int = 3, seed=0, p_drop: float = 0.0):
    """enc_layer_bwd's launches, epilogues and reductions: (dx, {name: gradient}, c1)."""
    T, Fc, D = x.shape[1], w.w1.shape[0], C // w.n_heads
    drop = p_drop > 0.0
    keep = lambda site, width: el.dropout_keep(seed, lens, T, width, site, p_drop) if drop else 1.0  # noqa: E731
    s = kernel_forward(x, lens, w, passes, seed, p_drop)  # the recompute
    valid = s["valid"]
    gm = g * valid
    dz2 = _ln_bwd(gm, s["zhat2"], s["inv2"], w.g2)
    dc2 = dz2 * keep(el.SITE_FFN_Y, C) * valid
    z = _conv(dc2, w.w2.permute(2, 0, 1).flip(0), 1, passes, valid)  # B_tap[c, n] = W_2[c, n, k - 1 - tap]
    dc1 = torch.where(s["hid"] > 0, z * (el.keep_scale(p_drop) if drop else 1.0), torch.zeros_like(z))
    dx1 = _conv(dc1, w.w1.permute(2, 0, 1).flip(0), 1, passes, valid) * valid + dz2
    dz1 = _ln_bwd(dx1, s["zhat1"], s["inv1"], w.g1)
    dy = dz1 * keep(el.SITE_ATTN_Y, C) * valid
    doh = _conv(dy, w.wo[:, :, 0][None], 1, passes)
    # the attention kernels, fp32 on the CUDA cores
    H = w.n_heads
    dh = el._heads(doh, H)
    qh, kh, vh = (el._heads(t, H) for t in s["qkv"].split(C, dim=-1))
    p, pd = s["p"], s["pd"]
    dp = dh @ vh.transpose(-2, -1) + el.band_scatter(dh @ w.rv.t(), w.window)
    if drop:
        dp = dp * el.attention_keep(seed, lens, H, T, p_drop)
    smask = valid[:, None, :, 0, None] * valid[:, None, None, :, 0]
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * smask / math.sqrt(D)
    dclog = el.band_extract(ds, w.window)
    dq, dk, dv = (el._merge(t) for t in (ds @ kh + dclog @ w.rk, ds.transpose(-2, -1) @ qh,
                                         pd.transpose(-2, -1) @ dh))
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    dx = (dz1 + _conv(dqkv, _qkv_weight(w)[None], 1, passes)) * valid
    # the weight gradients: the tensor cores' problems, then the CUDA cores'
    wg = lambda X, Y, shift=0, mask_x=None: _wgrad(X, Y, shift, passes, N_SPLIT, mask_x)  # noqa: E731
    grads = {}
    for name, d in (("q", dq), ("k", dk), ("v", dv)):
        grads[f"w{name}"], grads[f"b{name}"] = wg(x, d, mask_x=valid)[..., None], d.sum(dim=(0, 1))
    grads["wo"], grads["bo"] = wg(s["att"], dy)[..., None], dy.sum(dim=(0, 1))
    pad = (K - 1) // 2
    grads["w1"] = torch.stack([wg(s["x1"] * valid, dc1, j - pad) for j in range(K)], dim=2)  # masked, then shifted
    grads["w2"] = torch.stack([wg(s["hid"], dc2, j - pad) for j in range(K)], dim=2)
    grads["b1"], grads["b2"] = dc1.sum(dim=(0, 1)), dc2.sum(dim=(0, 1))
    grads["rk"] = torch.einsum("bhto,bhtd->od", dclog, qh)
    grads["rv"] = torch.einsum("bhto,bhtd->od", el.band_extract(pd, w.window), dh)
    grads["g1"], grads["be1"] = (dx1 * s["zhat1"]).sum(dim=(0, 1)), dx1.sum(dim=(0, 1))
    grads["g2"], grads["be2"] = (gm * s["zhat2"]).sum(dim=(0, 1)), gm.sum(dim=(0, 1))
    return dx, {n: grads[n] for n in el.PARAM_NAMES}, s["c1"]


_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731


def _port(name: str, a) -> np.ndarray:
    """A JAX kernel parameter in the port's layout."""
    a = np.asarray(a)
    if name[0] == "w":
        return np.transpose(a if a.ndim == 3 else a[None], (2, 1, 0))
    return a[0] if name[0] in "bg" else a


def _case(T: int, Fc: int):
    """Seeded inputs and weights in the JAX kernel's layouts: lens, valid, x, g, params, spec."""
    rng = np.random.RandomState(T + Fc)
    lens = np.array([T, T - T // 3], dtype=np.int32)
    valid = np.arange(T)[None, :] < lens[:, None]
    x = rng.randn(2, T, C).astype(np.float32)
    g = (rng.randn(2, T, C) * valid[..., None]).astype(np.float32)
    D = C // HEADS
    w = lambda *shape, fan: (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    params = {"wq": w(C, C, fan=C), "bq": w(1, C, fan=10), "wk": w(C, C, fan=C), "bk": w(1, C, fan=10),
              "wv": w(C, C, fan=C), "bv": w(1, C, fan=10), "rk": w(2 * WINDOW + 1, D, fan=D),
              "rv": w(2 * WINDOW + 1, D, fan=D), "wo": w(C, C, fan=C), "bo": w(1, C, fan=10),
              "g1": 1 + w(1, C, fan=100), "be1": w(1, C, fan=10), "w1": w(K, C, Fc, fan=K * C),
              "b1": w(1, Fc, fan=10), "w2": w(K, Fc, C, fan=K * Fc), "b2": w(1, C, fan=10),
              "g2": 1 + w(1, C, fan=100), "be2": w(1, C, fan=10)}
    spec = EncLayerSpec(channels=C, n_heads=HEADS, window=WINDOW, filter_channels=Fc, kernel_size=K,
                        interpret=True)
    return lens, valid, x, g, params, spec


def _refs(T: int, Fc: int, p_drop: float, gate=None):
    """(inputs, weights, valid, {"out", "x", weight names: reference}): JAX's
    interpret-mode kernel and its VJP at p=0, else the plain versions in fp64
    with the port's masks (at the relu decisions ``gate(x, lens, w)``)."""
    lens, valid, x, g, params, spec = _case(T, Fc)
    w = el.EncLayerWeights(*[_t(_port(n, params[n])) for n in el.PARAM_NAMES], n_heads=HEADS, window=WINDOW)
    args = (_t(x), torch.from_numpy(lens), w, _t(g))
    if p_drop == 0.0:
        def loss(x_, ps):
            out = fused_enc_layer(spec, jnp.float32(0.0), jnp.asarray(lens), x_, *ps)
            return jnp.sum(out * jnp.asarray(g)), out

        (_, out), (jdx, jgrads) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), [jnp.asarray(params[n]) for n in spec.param_names])
        ref = {"out": np.asarray(out), "x": np.asarray(jdx)}
        ref.update({n: _port(n, jgrads[i]) for i, n in enumerate(spec.param_names)})
        return args, valid, ref
    wd = w.with_tensors([t.double() for t in w.tensors().values()])
    xd, gd = args[0].double(), args[3].double()
    relu = None if gate is None else gate(*args[:3]).double()
    out = el.enc_layer_reference(xd, args[1], wd, SEED, p_drop)
    dx, grads = el.enc_layer_backward_reference(xd, args[1], wd, gd, SEED, p_drop, relu_gate=relu)
    return args, valid, {"out": out.numpy(), "x": dx.numpy(), **{n: t.numpy() for n, t in grads.items()}}


def _errors(out, dx, grads, valid, ref) -> dict:
    """name -> error over its tolerance: the output and dx at valid rows
    against B5_RTOL and DX_RTOL of their max|ref|, each weight gradient
    against WGRAD_RTOL of its max|ref| floored at GRAD_FLOOR of the largest
    leaf's."""
    errs = {}
    for name, ours, rtol in (("out", out, B5_RTOL), ("x", dx, DX_RTOL)):
        r = ref[name][valid]
        errs[name] = np.abs(ours.numpy()[valid] - r).max() / (rtol * np.abs(r).max())
    top = max(np.abs(ref[n]).max() for n in el.PARAM_NAMES)
    for n in el.PARAM_NAMES:
        scale = max(np.abs(ref[n]).max(), GRAD_FLOOR * top)
        errs[n] = np.abs(grads[n].numpy() - ref[n]).max() / (WGRAD_RTOL * scale)
    return errs


@pytest.mark.parametrize("T,Fc,p_drop", CASES, ids=IDS)
def test_kernel_order_of_products_meets_the_tolerances(T, Fc, p_drop):
    """Each error over its tolerance, with 3 TF32 products: well inside
    (the key bias, whose true gradient is zero, inside)."""
    def gate(x, lens, w):  # the emulation's own relu decisions
        return kernel_forward(x, lens, w, 3, SEED, p_drop)["c1"] > 0

    args, valid, ref = _refs(T, Fc, p_drop, gate)
    errs = {}
    with torch.no_grad():
        for passes in (3, 1):
            out = kernel_forward(*args[:3], passes, SEED, p_drop)["out"]
            dx, grads, _ = kernel_backward(*args, passes, SEED, p_drop)
            errs[passes] = _errors(out, dx, grads, valid, ref)
    worst = {passes: max(e, key=e.get) for passes, e in errs.items()}
    print(f"B5 T={T} F={Fc} p={p_drop}: worst error over its tolerance with 3 TF32 products "
          f"{worst[3]} {errs[3][worst[3]]:.3g} (out {errs[3]['out']:.3g}, dx {errs[3]['x']:.3g}); with 1 "
          f"{worst[1]} {errs[1][worst[1]]:.3g} (out {errs[1]['out']:.3g}, dx {errs[1]['x']:.3g})")
    assert len(errs[3]) == 2 + len(el.PARAM_NAMES)
    # the key bias's true gradient is zero (the softmax ignores a shift of every key): both sides
    # hold rounding at the floor's scale, as the plain fp32 backward does (0.08 of it here)
    assert errs[3].pop("bk") <= 1.0
    assert max(errs[3].values()) <= 0.1, errs[3]
    assert min(errs[1]["out"], errs[1]["x"]) > 1.0, errs[1]  # 1 product would miss
