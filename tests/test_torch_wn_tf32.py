"""B3's recompute backward as its kernels compute it on the tensor cores
(csrc/wn_coupling_common.cuh:backward_chain on csrc/conv_mma.cuh, the
weight gradients on csrc/wgrad_mma.cuh), emulated on the CPU by
ops/tf32.py: every product in 3xTF32 in the kernels' k-order, each conv
tap a shifted k-slice (tap-major), each k-step's MMAs added to the
accumulators in fp32 (``rz_steps=1``, as conv_mma.cuh does), and the weight
gradients over the frames as the MMAs' k in fixed-order slices, each
slice's register added into its partial every 1,024 frames
(``rz_steps=128``).

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

from chip_smoke import DX_RTOL, GRAD_FLOOR, WGRAD_RTOL
from speech_masters_thesis_tpu.ops.pallas.wn_coupling import WNSpec, fused_wn_coupling
from speech_masters_thesis_tpu_torch.ops import tf32
from speech_masters_thesis_tpu_torch.ops import wn_coupling as wn

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
    when valid_in is given), w_taps [taps, cin, n] (conv_mma::Weight)."""
    taps = w_taps.shape[0]
    if valid_in is not None:
        x = x * valid_in
    pad = (taps - 1) // 2 * dil
    a = torch.cat([_shift(x, j * dil - pad) for j in range(taps)], dim=-1)
    out = tf32.matmul(_rows(a), w_taps.reshape(-1, w_taps.shape[-1]), passes, rz_steps=1)
    return out.reshape(*x.shape[:2], -1)


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
    valid = (torch.arange(x0.shape[1])[None, :] < lens[:, None]).float()[..., None]
    L, k, H, dils = len(w.win), w.kernel_size, w.hidden, w.dilations
    one = lambda t: t[:, :, 0].t()[None]  # noqa: E731  a 1x1 conv's weight as B [1, cin, n]
    # recompute (forward_chain on the Mma engine)
    h = (_conv(x0, one(w.ws), 1, passes) + w.bs) * valid
    hs, xins, acts = [], [], []
    skip = None
    for i in range(L):
        hs.append(h)
        z = _conv(h, w.win[i].permute(2, 1, 0), dils[i], passes, valid) + w.bin[i]
        xins.append(z)
        act = torch.tanh(z[..., :H]) * torch.sigmoid(z[..., H:])
        acts.append(act)
        rs = _conv(act, one(w.wrs[i]), 1, passes) + w.brs[i]
        if i < L - 1:
            h = (h + rs[..., :H]) * valid
            skip = rs[..., H:] if skip is None else skip + rs[..., H:]
        else:
            skip = rs if skip is None else skip + rs
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


def _jax_case(case):
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

    def loss(x0_, p):
        out = fused_wn_coupling(spec, jnp.float32(0.0), jnp.asarray(lens), x0_, p["ws"], p["bs"], p["wins"],
                                p["bins"], p["wrss"], p["brss"], p["wend"], p["bend"])
        return jnp.sum(out * jnp.asarray(g))

    jdx, jg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x0), jax.tree.map(jnp.asarray, jw))
    conv = lambda a: np.transpose(np.asarray(a), (2, 1, 0))  # noqa: E731  [k, in, out] -> [out, in, k]
    ref = {"x0": np.asarray(jdx), "ws": conv(jg["ws"][None]), "bs": np.asarray(jg["bs"])[0],
           "wend": conv(jg["wend"][None]), "bend": np.asarray(jg["bend"])[0]}
    for i in range(layers):
        ref.update({f"win{i}": conv(jg["wins"][i]), f"bin{i}": np.asarray(jg["bins"][i])[0],
                    f"wrs{i}": conv(jg["wrss"][i][None]), f"brs{i}": np.asarray(jg["brss"][i])[0]})
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    weights = wn.WNWeights(
        ws=t(conv(jw["ws"][None])), bs=t(jw["bs"][0]), win=tuple(t(conv(a)) for a in jw["wins"]),
        bin=tuple(t(b[0]) for b in jw["bins"]), wrs=tuple(t(conv(a[None])) for a in jw["wrss"]),
        brs=tuple(t(b[0]) for b in jw["brss"]), wend=t(conv(jw["wend"][None])), bend=t(jw["bend"][0]),
        dilations=tuple(rate ** i for i in range(layers)))
    return t(x0), torch.from_numpy(lens), weights, t(g), valid[..., 0], ref


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
