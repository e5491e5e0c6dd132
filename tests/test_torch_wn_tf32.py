"""B3's and B6's forwards and B3's recompute backward as their kernels
compute them on the tensor cores (csrc/wn_coupling_common.cuh:forward and
backward_chain on csrc/conv_mma.cuh, the weight gradients on
csrc/wgrad_mma.cuh), emulated on the CPU by ops/tf32.py: every product in
3xTF32 in the kernels' k-order, each conv tap a shifted k-slice (tap-major,
each tap's channels in whole k-steps), each k-step's MMAs added to the
accumulators in fp32 (``rz_steps=1``, as conv_mma.cuh does), and the weight
gradients over the frames as the MMAs' k in fixed-order slices, each
slice's register added into its partial every 1,024 frames
(``rz_steps=128``). Splitting the operands once a block or per warp gives
the same TF32 halves, so the emulation covers either.

* The forwards (the conditioner alone, and the whole flow step: ActNorm,
  the InvConvNear as one [C, C] product, the conditioner) at p=0 against
  JAX's ``fused_wn_coupling`` and ``fused_flow_step`` (the Pallas kernels
  in interpret mode, as tests/test_torch_flow_step.py runs them), at p>0
  against the plain versions in fp64 with the port's hash masks (the JAX
  kernels draw the TPU's own bits): within chip_smoke's B3_RTOL with 3 TF32
  products; a single TF32 product misses. At Glow's taps and at 3 taps,
  rate 3 and 1 tap with widths that are not multiples of 4.

* The whole chain at a small size against JAX's VJP of ``fused_wn_coupling``
  (the Pallas kernel in interpret mode, as tests/test_torch_glow_train.py
  runs it): dx0 within DX_RTOL and every weight gradient within WGRAD_RTOL
  of chip_smoke.py, with 3 TF32 products; a single TF32 product misses.
* One weight-gradient problem at the main path's depth (8 x 384 frames, the
  slices of the train shape): within WGRAD_RTOL / 100 of fp64.
* The same at 3 and 1 taps, rates 3 and 1, and widths that are not
  multiples of 4 (the kernels stage such rows in 4-byte pieces).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import B3_RTOL, DX_RTOL, GRAD_FLOOR, WGRAD_RTOL
from speech_masters_thesis_tpu.ops.pallas.wn_coupling import WNSpec, fused_flow_step, fused_wn_coupling
from speech_masters_thesis_tpu_torch.ops import flow_step as fs
from speech_masters_thesis_tpu_torch.ops import tf32
from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn
from test_torch_tf32_split import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# (T, half, hidden, out, taps, rate, layers); batch 2
MAIN = (64, 8, 32, 16, 5, 2, 2)
OTHERS = ((40, 6, 10, 12, 3, 3, 3), (24, 5, 7, 10, 1, 1, 2))
FLUSH_STEPS = 128  # wgrad_mma.cuh: FLUSH slabs of KF frames, 8 frames a k-step


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def _shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    return wn._shift_rows(x, shift)


def _conv(x, w_taps, dil, passes, valid_in=None):
    """sum_tap x[t + tap * dil - pad] B_tap with the taps as shifted
    k-slices, tap-major: x [B, T, cin] (rows past the lengths zeroed on load
    when valid_in is given), w_taps [taps, cin, n] (conv_mma::Weight). Each
    tap's channels are padded with zeros to whole k-steps, as the kernels'
    32-channel slices are, so no k-step mixes two taps."""
    taps, cin, n = w_taps.shape
    if valid_in is not None:
        x = x * valid_in
    pad, fill = (taps - 1) // 2 * dil, -cin % tf32.KSTEP
    zeros = x.new_zeros(*x.shape[:2], fill)
    a = torch.cat([part for j in range(taps) for part in (_shift(x, j * dil - pad), zeros)], dim=-1)
    b = torch.cat([w_taps, w_taps.new_zeros(taps, fill, n)], dim=1).reshape(-1, n)
    out = tf32.matmul(_rows(a), b, passes, rz_steps=1)
    return out.reshape(*x.shape[:2], -1)


def _one(w: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv's weight [n, cin, 1] as B [1, cin, n]."""
    return w[:, :, 0].t()[None]


def kernel_chain(x0, lens, w: wn.WNWeights, passes: int = 3, seed=0, p_drop: float = 0.0):
    """forward_chain's launches and epilogues: (valid, hs, xins, acts, skip)."""
    T = x0.shape[1]
    valid = (torch.arange(T)[None, :] < lens[:, None]).to(x0.dtype)[..., None]
    L, H, dils = len(w.win), w.hidden, w.dilations
    h = (_conv(x0, _one(w.ws), 1, passes) + w.bs) * valid
    hs, xins, acts = [], [], []
    skip = None
    for i in range(L):
        hs.append(h)
        z = _conv(h, w.win[i].permute(2, 1, 0), dils[i], passes, valid) + w.bin[i]
        if p_drop > 0.0:
            z = z * wn.keep_mask(seed, lens, T, i, 2 * H, p_drop)
        xins.append(z)
        act = torch.tanh(z[..., :H]) * torch.sigmoid(z[..., H:])
        acts.append(act)
        rs = _conv(act, _one(w.wrs[i]), 1, passes) + w.brs[i]
        if i < L - 1:
            h = (h + rs[..., :H]) * valid
            skip = rs[..., H:] if skip is None else skip + rs[..., H:]
        else:
            skip = rs if skip is None else skip + rs
    return valid, hs, xins, acts, skip


def kernel_forward(x0, lens, w: wn.WNWeights, passes: int = 3, seed=0, p_drop: float = 0.0):
    """out [B, T, C] by wn_coupling_common.cuh:forward: the chain, then the
    end 1x1 on the masked skip sum."""
    valid, *_, skip = kernel_chain(x0, lens, w, passes, seed, p_drop)
    return _conv(skip, _one(w.wend), 1, passes, valid) + w.bend


def kernel_flow_step(x, lens, aln, alb, mt, w: wn.WNWeights, passes: int = 3, seed=0, p_drop: float = 0.0):
    """(xc, out) by flow_step_fwd.cu: the ActNorm in fp32 on the staged rows,
    xc = x1 mt as a 1x1 conv, then the conditioner on xc's first half."""
    valid = (torch.arange(x.shape[1])[None, :] < lens[:, None]).to(x.dtype)[..., None]
    x1 = (alb + torch.exp(aln) * x) * valid
    xc = _conv(x1, mt[None], 1, passes)
    return xc, kernel_forward(xc[..., :x.shape[2] // 2], lens, w, passes, seed, p_drop)


def _wgrad(X, Y, shift, passes, n_split, mask_x=None):
    """sum_r Y[r, n] X[r + shift, m] -> [n, m]: the frames in n_split
    slices, each its own truncating register flushed every FLUSH_STEPS
    k-steps, the slices' partials added in order."""
    Xs = _shift(X, shift)
    if mask_x is not None:
        Xs = Xs * mask_x
    xr, yr = _rows(Xs), _rows(Y)
    chunk = -(-xr.shape[0] // n_split)
    total = torch.zeros(xr.shape[1], yr.shape[1])
    for s in range(n_split):
        rows = slice(s * chunk, (s + 1) * chunk)
        total = total + tf32.matmul(xr[rows].t().contiguous(), yr[rows], passes, rz_steps=FLUSH_STEPS)
    return total.t()


def kernel_backward(x0, lens, w: wn.WNWeights, g, passes: int = 3, n_split: int = 4):
    """(dx0, {leaf: gradient}) by the kernels' launches and epilogues, p = 0."""
    L, k, H, dils = len(w.win), w.kernel_size, w.hidden, w.dilations
    valid, hs, xins, acts, skip = kernel_chain(x0, lens, w, passes)  # the recompute
    # the transposed products
    dskip = _conv(g, w.wend[:, :, 0][None], 1, passes, valid) * valid
    dh = [None] * L
    dxin = [None] * L
    for i in reversed(range(L)):
        last = i == L - 1
        drs = dskip if last else torch.cat([dh[i + 1], dskip], dim=-1)
        dacts = _conv(drs, w.wrs[i][:, :, 0][None], 1, passes)
        th, sg = torch.tanh(xins[i][..., :H]), torch.sigmoid(xins[i][..., H:])
        dxin[i] = torch.cat([dacts * sg * (1 - th * th), dacts * th * sg * (1 - sg)], dim=-1)
        flipped = w.win[i].permute(2, 0, 1).flip(0)  # B_tap[c, n] = W[c, n, k - 1 - tap]
        z = _conv(dxin[i], flipped, dils[i], passes, valid)
        dh[i] = z * valid if last else (dh[i + 1] + z) * valid
    dx0 = _conv(dh[0], w.ws[:, :, 0][None], 1, passes, valid) * valid
    # the weight gradients (wn_coupling_common.cuh:problems)
    wg = lambda X, Y, shift=0, mask_x=None: _wgrad(X, Y, shift, passes, n_split, mask_x)  # noqa: E731
    grads = {"ws": wg(x0, dh[0])[..., None], "bs": dh[0].sum(dim=(0, 1)),
             "wend": wg(skip, g, mask_x=valid)[..., None], "bend": g.sum(dim=(0, 1))}
    for i in range(L):
        pad = (k - 1) // 2 * dils[i]
        grads[f"win{i}"] = torch.stack([wg(hs[i], dxin[i], j * dils[i] - pad) for j in range(k)], dim=2)
        grads[f"bin{i}"] = dxin[i].sum(dim=(0, 1))
        drs = dskip if i == L - 1 else torch.cat([dh[i + 1], dskip], dim=-1)
        grads[f"wrs{i}"] = wg(acts[i], drs)[..., None]
        grads[f"brs{i}"] = drs.sum(dim=(0, 1))
    return dx0, grads


_conv_layout = lambda a: np.transpose(np.asarray(a), (2, 1, 0))  # noqa: E731  [k, in, out] -> [out, in, k]
_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731


def _numpy_case(case):
    """Seeded inputs and weights in the JAX kernels' layouts: lens, valid,
    x0, g, the weights, the spec, then the flow step's x, aln, alb, mt."""
    T, half, H, C, K, rate, layers = case
    rng = np.random.RandomState(T)
    lens = np.array([T, T - T // 3], dtype=np.int32)
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None]
    x0 = (rng.randn(2, T, half) * valid).astype(np.float32)
    g = rng.randn(2, T, C).astype(np.float32)
    w = lambda *shape: (rng.randn(*shape) / np.sqrt(shape[-2] if len(shape) > 1 else 10)).astype(np.float32)  # noqa: E731
    rs = [2 * H if i < layers - 1 else H for i in range(layers)]
    jw = {"ws": w(half, H), "bs": w(1, H), "wins": tuple(w(K, H, 2 * H) for _ in range(layers)),
          "bins": tuple(w(1, 2 * H) for _ in range(layers)), "wrss": tuple(w(H, r) for r in rs),
          "brss": tuple(w(1, r) for r in rs), "wend": w(H, C), "bend": w(1, C)}
    spec = WNSpec(half=half, hidden=H, out_channels=C, kernel_size=K, dilation_rate=rate, n_layers=layers,
                  p_drop=0.0, interpret=True)
    flow = {"x": (rng.randn(2, T, C) * valid).astype(np.float32), "aln": (0.1 * rng.randn(1, C)).astype(np.float32),
            "alb": (0.1 * rng.randn(1, C)).astype(np.float32),
            "mt": np.linalg.qr(rng.randn(C, C))[0].astype(np.float32)}
    return lens, valid, x0, g, jw, spec, flow


def _port_weights(jw: dict, rate: int) -> wn.WNWeights:
    conv = _conv_layout
    return wn.WNWeights(
        ws=_t(conv(jw["ws"][None])), bs=_t(jw["bs"][0]), win=tuple(_t(conv(a)) for a in jw["wins"]),
        bin=tuple(_t(b[0]) for b in jw["bins"]), wrs=tuple(_t(conv(a[None])) for a in jw["wrss"]),
        brs=tuple(_t(b[0]) for b in jw["brss"]), wend=_t(conv(jw["wend"][None])), bend=_t(jw["bend"][0]),
        dilations=tuple(rate ** i for i in range(len(jw["wins"]))))


def _jax_case(case):
    lens, valid, x0, g, jw, spec, _ = _numpy_case(case)
    layers = len(jw["wins"])

    def loss(x0_, p):
        out = fused_wn_coupling(spec, jnp.float32(0.0), jnp.asarray(lens), x0_, p["ws"], p["bs"], p["wins"],
                                p["bins"], p["wrss"], p["brss"], p["wend"], p["bend"])
        return jnp.sum(out * jnp.asarray(g))

    jdx, jg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x0), jax.tree.map(jnp.asarray, jw))
    conv = _conv_layout
    ref = {"x0": np.asarray(jdx), "ws": conv(jg["ws"][None]), "bs": np.asarray(jg["bs"])[0],
           "wend": conv(jg["wend"][None]), "bend": np.asarray(jg["bend"])[0]}
    for i in range(layers):
        ref.update({f"win{i}": conv(jg["wins"][i]), f"bin{i}": np.asarray(jg["bins"][i])[0],
                    f"wrs{i}": conv(jg["wrss"][i][None]), f"brs{i}": np.asarray(jg["brss"][i])[0]})
    return _t(x0), torch.from_numpy(lens), _port_weights(jw, spec.dilation_rate), _t(g), valid[..., 0], ref


@pytest.fixture(scope="module")
def jax_case():
    return _jax_case(MAIN)


def _errors(dx0, grads, valid, ref) -> dict:
    """leaf -> error over its tolerance: dx0 at valid frames against DX_RTOL
    of its max|ref|, each weight gradient against WGRAD_RTOL of its max|ref|
    floored at GRAD_FLOOR of the largest leaf's (chip_smoke.leaf_report)."""
    dref = ref["x0"][valid]
    out = {"x0": np.abs(dx0.numpy()[valid] - dref).max() / (DX_RTOL * np.abs(dref).max())}
    top = max(np.abs(r).max() for n, r in ref.items() if n != "x0")
    for name, r in ref.items():
        if name != "x0":
            scale = max(np.abs(r).max(), GRAD_FLOOR * top)
            out[name] = np.abs(grads[name].numpy() - r).max() / (WGRAD_RTOL * scale)
    return out


def test_kernel_order_of_products_meets_the_tolerances_against_jax(jax_case):
    x0, lens, w, g, valid, ref = jax_case
    with torch.no_grad():
        errs3 = _errors(*kernel_backward(x0, lens, w, g, passes=3), valid, ref)
        errs1 = _errors(*kernel_backward(x0, lens, w, g, passes=1), valid, ref)
    assert len(errs3) == 5 + 4 * len(w.win)
    assert max(errs3.values()) <= 0.1, errs3   # 3 products: well inside the unchanged tolerances
    assert max(errs1.values()) > 1.0, errs1    # 1 product would miss


def test_frame_deep_wgrad_problem_meets_wgrad_rtol():
    """A dilated-conv tap's weight gradient at the train shape's depth: h_i
    [8 x 384 frames, 192] against dx_in_i [.., 384] in wgrad_mma.cuh's 3
    slices of 1,024 frames, each register flushed into its partial every
    1,024 frames, against fp64: 100x inside WGRAD_RTOL."""
    rng = np.random.RandomState(5)
    X = torch.from_numpy(rng.randn(8, 384, 192).astype(np.float32))
    Y = torch.from_numpy((rng.randn(8, 384, 384) * 1e-2).astype(np.float32))
    ours = _wgrad(X, Y, -4, 3, 3)
    ref = torch.einsum("btn,btm->nm", Y.double(), _shift(X, -4).double())
    assert (ours.double() - ref).abs().max().item() <= WGRAD_RTOL / 100 * ref.abs().max().item()


@pytest.mark.parametrize("case", OTHERS, ids=["k3-rate3", "k1-odd-widths"])
def test_kernel_order_meets_the_tolerances_at_other_taps_and_widths(case):
    x0, lens, w, g, valid, ref = _jax_case(case)
    with torch.no_grad():
        errs = _errors(*kernel_backward(x0, lens, w, g), valid, ref)
    assert len(errs) == 5 + 4 * len(w.win)
    assert max(errs.values()) <= 0.1, errs


# (case, the conditioner alone or the whole flow step, p): Glow's taps at p=0
# and p>0 on both, then 3 taps at rate 3 and 1 tap at widths not multiples of 4
FORWARD_CASES = [(MAIN, "coupling", 0.0), (MAIN, "coupling", 0.1), (MAIN, "flow", 0.0), (MAIN, "flow", 0.1),
                 (OTHERS[0], "coupling", 0.1), (OTHERS[0], "flow", 0.0), (OTHERS[1], "coupling", 0.0),
                 (OTHERS[1], "flow", 0.1)]
FORWARD_IDS = [f"{name}-{kind}-p{p}" for (case, kind, p), name in zip(
    FORWARD_CASES, ["k5"] * 4 + ["k3-rate3"] * 2 + ["k1-odd-widths"] * 2)]
FORWARD_SEED = 77


def _forward_refs(case, kind: str, p_drop: float):
    """(valid [B, T], the kernel's inputs, {output: reference}): JAX's
    interpret-mode kernel at p=0, else the plain version in fp64 with the
    port's masks."""
    lens, valid, x0, _, jw, spec, flow = _numpy_case(case)
    w = _port_weights(jw, spec.dilation_rate)
    lens_t = torch.from_numpy(lens)
    params = [jnp.asarray(jw[n]) if n in ("ws", "bs", "wend", "bend") else tuple(map(jnp.asarray, jw[n]))
              for n in ("ws", "bs", "wins", "bins", "wrss", "brss", "wend", "bend")]
    if kind == "coupling":
        args = (_t(x0), lens_t, w)
        if p_drop == 0.0:
            ref = {"out": np.asarray(fused_wn_coupling(spec, jnp.float32(0.0), jnp.asarray(lens), jnp.asarray(x0),
                                                       *params))}
        else:
            wd = wn.WNWeights.from_flat([t.double() for t in w.flat()], w.dilations)
            ref = {"out": wn.wn_coupling_reference(args[0].double(), lens_t, wd, FORWARD_SEED, p_drop).numpy()}
    else:
        args = (_t(flow["x"]), lens_t, _t(flow["aln"][0]), _t(flow["alb"][0]), _t(flow["mt"]), w)
        if p_drop == 0.0:
            xc, out = fused_flow_step(spec, jnp.float32(0.0), jnp.asarray(lens),
                                      *(jnp.asarray(flow[n]) for n in ("x", "aln", "alb", "mt")), *params)
        else:
            wd = wn.WNWeights.from_flat([t.double() for t in w.flat()], w.dilations)
            xc, out = (r.numpy() for r in fs.flow_step_reference(
                *(a.double() for a in args[:1]), lens_t, *(a.double() for a in args[2:5]), wd, FORWARD_SEED, p_drop))
        ref = {"xc": np.asarray(xc), "out": np.asarray(out)}
    return valid[..., 0], args, ref


@pytest.mark.parametrize("case,kind,p_drop", FORWARD_CASES, ids=FORWARD_IDS)
def test_forward_kernel_order_meets_b3_rtol(case, kind, p_drop):
    """Each output's error at valid frames over B3_RTOL of its max|ref|:
    under 0.1 with 3 TF32 products, beyond 1 with 1."""
    valid, args, ref = _forward_refs(case, kind, p_drop)
    emulate = kernel_forward if kind == "coupling" else kernel_flow_step
    errs = {}
    for passes in (3, 1):
        with torch.no_grad():
            outs = emulate(*args, passes=passes, seed=FORWARD_SEED, p_drop=p_drop)
        outs = dict(zip(ref, outs if kind == "flow" else (outs,)))
        errs[passes] = {n: np.abs(outs[n].numpy()[valid] - r[valid]).max() / (B3_RTOL * np.abs(r[valid]).max())
                        for n, r in ref.items()}
    assert max(errs[3].values()) <= 0.1, errs    # 3 products: well inside the unchanged tolerance
    assert max(errs[1].values()) > 1.0, errs     # 1 product would miss
