"""GatedHiFi block: plain PyTorch versions, weight packing, dropout masks and
the kernel wrappers (forward, recompute backward, weight-gradient reduction).

Counterpart of speech_masters_thesis_tpu/ops/pallas/gated_hifi.py
(``fused_gated_hifi`` and its custom VJP). The CUDA kernels are
``csrc/gated_hifi_fwd.cu`` and ``csrc/gated_hifi_bwd.cu`` (fp32), and
``csrc/gated_hifi_fwd_bf16.cu`` and ``csrc/gated_hifi_bwd_bf16.cu`` (bf16).
For a CUDA tensor ``gated_hifi`` runs ``GatedHiFiFunction``, whose forward
and backward launch them; for an fp32 CPU tensor it runs
``gated_hifi_reference``, which CPU autograd differentiates. Nothing falls
back: a CUDA tensor the kernels do not take raises.

Two modes, as the TPU kernel's ``dot_dtype`` (the input's dtype) has them.
fp32: x, the weights and g float32. bf16 (the JAX package's mixed-precision
training): x, every weight and g bfloat16, and each product's operands
rounded to bf16 exactly where the TPU kernel calls ``.astype(dot_dtype)``,
the products summed in fp32, everything between them (biases, relu,
dropout, the gate, the residual) fp32; out and dx are stored in bf16, the
weight gradients summed in fp32 and cast to bf16 once. The bf16 kernels
take res_scale 1 only (every shipped config's). A bf16 CPU tensor runs
``GatedHiFiFunction`` too, whose forward and backward are then the plain
versions: autograd through the rounded plain forward would round the
cotangents where the TPU kernel's backward does not.

Semantics every version keeps:
  * the input arrives pre-masked (``x * mask``);
  * the dilated convs zero-pad only outside [0, T), the array length, so
    inside [len_b, T) the expand bias still reaches valid frames through
    the conv (the reference model does the same);
  * the output is ``(x + scale * v)`` masked per sequence past
    ``min(T, lens[b])``, so the output's cotangent is zero there;
  * dropout (``p_drop > 0``) keeps each element of a branch's two sites
    with probability ``1 - p`` (quantized to 2^-16) and scales it by
    ``1 / (1 - p)``. The masks are a pure function of (seed, sequence,
    branch, absolute frame, channel): one 32-bit draw per element feeds
    both sites, the high 16 bits the one before the conv and the low 16 bits
    the one after it (the TPU kernel's economy, ``_branch_masks``). The
    kernels compute the same hash, so kernel and plain version agree bit
    for bit on the masks and the backward regenerates them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import round_bf16, same
from speech_masters_thesis_tpu_torch.ops.hash import U32, draw, stream_key

# must equal MAX_DEPTH in csrc/gated_hifi_common.cuh: it spaces the (sequence, branch) keys
MASK_KEY_DEPTH = 8


@dataclass(frozen=True)
class GatedHiFiWeights:
    """One block's weights in the kernel's layout, all of one dtype (float32,
    or bfloat16 in the bf16 mode; float64 on the CPU's plain path).

    wall [W, depth*H] and ball [depth*H]: the branch 1x1 expands side by side.
    ks[d] [k_d, H, H]: branch d's dilated conv as (tap, in, out); cb [depth, H]
    its bias. w1 [depth, H, H] (in, out) and b1 [depth, H]: the branch 1x1s.
    wg [W, W] (in, out) and bg [W]: the gate 1x1. H = 2 * W. A gradient of
    the block has the same layout.
    """

    wall: torch.Tensor
    ball: torch.Tensor
    ks: tuple[torch.Tensor, ...]
    cb: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    wg: torch.Tensor
    bg: torch.Tensor
    dilations: tuple[int, ...]

    @property
    def kernels(self) -> tuple[int, ...]:
        return tuple(k.shape[0] for k in self.ks)

    def tensors(self) -> dict[str, torch.Tensor]:
        """The tensors by name, the branch kernels as ``ks.{d}``."""
        out = {f.name: getattr(self, f.name) for f in fields(self) if f.name not in ("ks", "dilations")}
        out.update({f"ks.{d}": k for d, k in enumerate(self.ks)})
        return out


def pack_weights(params: Mapping[str, torch.Tensor], dilations: Sequence[int]) -> GatedHiFiWeights:
    """Per-branch reference ``state_dict`` tensors -> ``GatedHiFiWeights``.

    Keys are the block's own: ``blocks.{d}.0`` (branch expand, Conv1d W->H),
    ``blocks.{d}.1.model.2`` (dilated conv H->H), ``blocks.{d}.1.model.5``
    (branch 1x1 H->H) and ``gate`` (W->W); torch Conv1d weights are
    [out, in, k]. Differentiable: gradients of the packed tensors reach
    ``params`` through ``cat``/``permute``.
    """
    depth = len(dilations)
    branch = [f"blocks.{d}" for d in range(depth)]
    return GatedHiFiWeights(
        wall=torch.cat([params[f"{p}.0.weight"][:, :, 0].t() for p in branch], dim=1).contiguous(),
        ball=torch.cat([params[f"{p}.0.bias"] for p in branch]).contiguous(),
        ks=tuple(params[f"{p}.1.model.2.weight"].permute(2, 1, 0).contiguous() for p in branch),
        cb=torch.stack([params[f"{p}.1.model.2.bias"] for p in branch]).contiguous(),
        w1=torch.stack([params[f"{p}.1.model.5.weight"][:, :, 0].t() for p in branch]).contiguous(),
        b1=torch.stack([params[f"{p}.1.model.5.bias"] for p in branch]).contiguous(),
        wg=params["gate.weight"][:, :, 0].t().contiguous(),
        bg=params["gate.bias"].contiguous(),
        dilations=tuple(int(d) for d in dilations),
    )


# ---------------------------------------------------------------------------
# dropout masks: the hash of csrc/gated_hifi_common.cuh in int64 torch ops
# ---------------------------------------------------------------------------
def dropout_key(seed: int, b: int, d: int) -> int:
    """The u32 key of sequence ``b``, branch ``d`` under ``seed``."""
    return stream_key(seed, b * MASK_KEY_DEPTH + d)


def dropout_bits(seed: int, batch: int, d: int, t0: int, rows: int, hidden: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """[batch, rows, hidden] int64 holding the u32 draws of branch ``d`` at
    absolute frames t0 .. t0+rows-1, channels 0 .. hidden-1."""
    keys = torch.tensor([dropout_key(seed, b, d) for b in range(batch)], dtype=torch.int64,
                        device=device)[:, None, None]
    t = torch.arange(t0, t0 + rows, dtype=torch.int64, device=device)
    c = torch.arange(hidden, dtype=torch.int64, device=device)
    return draw(keys, (t[:, None] * hidden + c[None, :])[None])


def keep_threshold(p_drop: float) -> int:
    """A 16-bit field keeps its element when it is >= this (0: no dropout)."""
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"p_drop must be in [0, 1), got {p_drop}")
    return max(1, int(p_drop * 65536.0 + 0.5)) if p_drop > 0.0 else 0


def keep_scale(p_drop: float) -> float:
    """The float32 factor a kept element is multiplied by."""
    return float(np.float32(1.0 / (1.0 - p_drop)))


def branch_masks(seed: int, batch: int, d: int, t0: int, rows: int, hidden: int, p_drop: float,
                 device: torch.device | str = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Both dropout masks of branch ``d`` (before and after the conv), each
    [batch, rows, hidden] float32 of 0 or 1/(1-p)."""
    bits = dropout_bits(seed, batch, d, t0, rows, hidden, device)
    th, scale = keep_threshold(p_drop), keep_scale(p_drop)
    m0 = ((bits >> 16) >= th).to(torch.float32) * scale
    m1 = ((bits & 0xFFFF) >= th).to(torch.float32) * scale
    return m0, m1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _check_dtypes(x: torch.Tensor, w: GatedHiFiWeights, g: torch.Tensor | None = None) -> None:
    """x, every weight (and g) share one dtype."""
    for name, t in {**w.tensors(), **({} if g is None else {"g": g})}.items():
        if t.dtype != x.dtype:
            raise ValueError(f"gated_hifi: {name} is {t.dtype} but x is {x.dtype}: x, every weight and g "
                             "share one dtype (float32 or bfloat16)")


def _operands(x: torch.Tensor, w: GatedHiFiWeights):
    """(round, x, w) for the plain versions: in bf16 mode x and w in fp32 and
    ``round`` rounding a product operand to bf16; otherwise as they are and
    no rounding. A product of two bf16 values is exact in fp32, so an fp32
    product of rounded operands is the TPU kernel's bf16 x bf16 -> f32 dot
    up to the order of its sums (a bf16 torch.matmul would round its output
    too)."""
    _check_dtypes(x, w)
    if x.dtype != torch.bfloat16:
        return same, x, w
    wf = _weights_from({k: v.to(torch.float32) for k, v in w.tensors().items()}, w.dilations)
    return round_bf16, x.to(torch.float32), wf


def _branches(x: torch.Tensor, w: GatedHiFiWeights, res_scale: float, p_drop: float, seed: int,
              rnd=same):
    """Per branch of the plain forward: (a, h1, zp) with a = relu(z)*m0 (the
    conv input), h1 = relu(c)*m1 (the 1x1 input) and zp = z + scale*h;
    ``rnd`` rounds the product operands (``_operands``)."""
    B, T, W = x.shape
    H = 2 * W
    z_all = rnd(x) @ rnd(w.wall) + w.ball                     # [B, T, depth*H]
    out = []
    for d, (kernel, dil) in enumerate(zip(w.ks, w.dilations)):
        z = z_all[..., d * H:(d + 1) * H]
        a = torch.relu(z)
        if p_drop > 0.0:
            m0, m1 = branch_masks(seed, B, d, 0, T, H, p_drop, x.device)
            a = a * m0
        k = kernel.shape[0]
        c = F.conv1d(rnd(a).transpose(1, 2), rnd(kernel).permute(2, 1, 0), w.cb[d],
                     padding=(k - 1) // 2 * dil, dilation=dil).transpose(1, 2)
        h1 = torch.relu(c)
        if p_drop > 0.0:
            h1 = h1 * m1
        out.append((a, h1, z + res_scale * (rnd(h1) @ rnd(w.w1[d]) + w.b1[d])))
    return out


def _gate(zps: Sequence[torch.Tensor], W: int):
    """tanh(t) weighted by the softmax over branches of s: (u, weights, tanh t)."""
    ts = [torch.tanh(zp[..., :W]) for zp in zps]
    ss = [zp[..., W:] for zp in zps]
    s_max = ss[0]
    for s in ss[1:]:
        s_max = torch.maximum(s_max, s)
    exps = [torch.exp(s - s_max) for s in ss]
    den = exps[0]
    for e in exps[1:]:
        den = den + e
    ps = [e / den for e in exps]
    u = torch.zeros_like(ts[0])
    for t, p in zip(ts, ps):
        u = u + t * p
    return u, ps, ts


def gated_hifi_reference(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights,
                         res_scale: float = 1.0, p_drop: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch GatedHiFi block forward.

    x: [B, T, W] pre-masked input; lens: [B] int valid lengths; dropout at
    rate ``p_drop`` with the masks of ``seed``. Returns [B, T, W] in x's
    dtype, zero past ``min(T, lens[b])``. bf16: the products' operands
    rounded as the TPU kernel rounds them, the rest fp32, the output rounded.
    """
    B, T, W = x.shape
    keep_threshold(p_drop)  # validates p_drop
    rnd, xf, wf = _operands(x, w)
    u, _, _ = _gate([zp for *_, zp in _branches(xf, wf, res_scale, p_drop, seed, rnd)], W)
    out = xf + res_scale * (rnd(u) @ rnd(wf.wg) + wf.bg)
    valid = torch.arange(T, device=x.device)[None, :] < lens.to(x.device)[:, None]
    return (out * valid[..., None].to(out.dtype)).to(x.dtype)


def gated_hifi_backward_reference(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights,
                                  g: torch.Tensor, res_scale: float = 1.0, p_drop: float = 0.0,
                                  seed: int = 0) -> Tuple[torch.Tensor, GatedHiFiWeights]:
    """Plain version of the backward: autograd through ``gated_hifi_reference``
    (bf16: the TPU kernel's backward formulas with its rounding points,
    ``backward_buffers_reference`` then ``weight_grad_reduce_reference``).

    Returns (dx, the weights' gradients as ``GatedHiFiWeights``).
    """
    if x.dtype == torch.bfloat16:
        dx, bufs = backward_buffers_reference(x, lens, w, g, res_scale, p_drop, seed)
        return dx, weight_grad_reduce_reference(x, bufs, w.kernels, w.dilations, res_scale)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.tensors().items()}
        x_leaf = x.detach().requires_grad_(True)
        wl = _weights_from(leaves, w.dilations)
        out = gated_hifi_reference(x_leaf, lens, wl, res_scale, p_drop, seed)
        grads = torch.autograd.grad(out, [x_leaf, *leaves.values()], g)
    return grads[0], _weights_from(dict(zip(leaves, grads[1:])), w.dilations)


def _weights_from(named: Mapping[str, torch.Tensor], dilations: Sequence[int]) -> GatedHiFiWeights:
    ks = tuple(named[f"ks.{d}"] for d in range(len(dilations)))
    rest = {k: v for k, v in named.items() if not k.startswith("ks.")}
    return GatedHiFiWeights(ks=ks, dilations=tuple(dilations), **rest)


# frames of one row of the bf16 backward's bias partials (csrc/gated_hifi_bwd_bf16.cu's TM)
BIAS_TILE = 128


@dataclass(frozen=True)
class BackwardBuffers:
    """What the backward's tile passes leave in device memory for the weight
    gradients, all [B, T, depth*H] but u and gv ([B, T, W]), in x's dtype.

    a: relu(z)*m0 (the conv input); h1: relu(c)*m1 (the branch 1x1 input);
    dzp: the cotangent of the branch outputs z + scale*h; dc: of the conv
    outputs; dz: of the branch expands; u: the gate input; gv: the cotangent
    of v, scale * g masked past the length.

    bf16 mode: every buffer holds a product operand, rounded where the TPU
    kernel rounds it at its dots, and dzp is the copy its dW1 takes (scale *
    dzp, rounded). The bias gradients' fp32 sums come apart, in ``bias``:
    [B * ceil(T / BIAS_TILE), 3*depth*H + W] fp32, row b * ceil(T /
    BIAS_TILE) + i the column sums over frames [i * BIAS_TILE, min(T, (i + 1)
    * BIAS_TILE)) of sequence b of dz | dc | scale * dzp | gv, in fp32 before
    any rounding (``bias_partials``). fp32 mode: ``bias`` is None and the
    reduction sums the buffers' columns.
    """

    a: torch.Tensor
    h1: torch.Tensor
    dzp: torch.Tensor
    dc: torch.Tensor
    dz: torch.Tensor
    u: torch.Tensor
    gv: torch.Tensor
    bias: torch.Tensor | None = None


def bias_partials(*columns: torch.Tensor) -> torch.Tensor:
    """The frame tiles' column sums of [B, T, .] fp32 tensors side by side:
    [B * ceil(T / BIAS_TILE), total columns], each tile's frames of its own
    sequence only, the last tile of a sequence its T % BIAS_TILE frames."""
    cat = torch.cat(columns, dim=-1)
    B, T, C = cat.shape
    n = -(-T // BIAS_TILE)
    padded = F.pad(cat, (0, 0, 0, n * BIAS_TILE - T))
    return padded.view(B, n, BIAS_TILE, C).sum(dim=2).reshape(B * n, C)


def _shift_time(a: torch.Tensor, shift: int) -> torch.Tensor:
    """out[:, t] = a[:, t + shift], zero where t + shift is outside [0, T)."""
    T = a.shape[1]
    out = torch.zeros_like(a)
    if abs(shift) < T:
        if shift >= 0:
            out[:, :T - shift] = a[:, shift:]
        else:
            out[:, -shift:] = a[:, :T + shift]
    return out


def backward_buffers_reference(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights,
                               g: torch.Tensor, res_scale: float = 1.0, p_drop: float = 0.0,
                               seed: int = 0, gates: Tuple[torch.Tensor, torch.Tensor] | None = None
                               ) -> Tuple[torch.Tensor, BackwardBuffers]:
    """Plain version of the backward kernel's tile passes: dx and the
    buffers, by the formulas of csrc/gated_hifi_bwd.cu. With
    ``weight_grad_reduce_reference`` it gives what autograd gives. bf16: the
    operands of du, dh1, the transposed conv and dx rounded to bf16 (the TPU
    kernel's _bwd_kernel), dx and every buffer stored in bf16 with the bias
    partials beside them (``BackwardBuffers``). ``gates`` (a > 0,
    h1 > 0 as [B, T, depth*H] booleans, e.g. a kernel's own) replaces the
    relu and dropout decisions the backward takes its gradient at: where a
    pre-activation lies within rounding of 0 two versions may decide
    apart, and that element's gradient then differs by a whole term."""
    B, T, W = x.shape
    H = 2 * W
    keep = keep_scale(p_drop)
    _check_dtypes(x, w, g)
    rnd, xf, wf = _operands(x, w)
    valid = (torch.arange(T, device=x.device)[None, :] < lens.to(x.device)[:, None])[..., None]
    g_masked = g.to(xf.dtype) * valid.to(xf.dtype)
    gv = res_scale * g_masked
    du = rnd(gv) @ rnd(wf.wg).t()
    branches = _branches(xf, wf, res_scale, p_drop, seed, rnd)
    u, ps, ths = _gate([zp for *_, zp in branches], W)
    dzps, dcs, dzs = [], [], []
    for d, ((a, h1, _), kernel, dil) in enumerate(zip(branches, wf.ks, wf.dilations)):
        p, th = ps[d], ths[d]
        cols = slice(d * H, (d + 1) * H)
        on_a, on_h = (a > 0, h1 > 0) if gates is None else (gates[0][..., cols], gates[1][..., cols])
        dzp = torch.cat([du * p * (1 - th * th), du * p * (th - u)], dim=-1)
        # relu(c)*m1 > 0 exactly where c > 0 and the element is kept, and m1 = keep there
        dc = res_scale * (rnd(dzp) @ rnd(wf.w1[d]).t()) * on_h * keep
        half = (kernel.shape[0] - 1) // 2
        da = sum(_shift_time(rnd(dc), -(j - half) * dil) @ rnd(kernel[j]).t() for j in range(kernel.shape[0]))
        dzps.append(dzp)
        dcs.append(dc)
        dzs.append(dzp + da * on_a * keep)
    dz = torch.cat(dzs, dim=-1)
    dx = g_masked + rnd(dz) @ rnd(wf.wall).t()
    cat = lambda xs: torch.cat(xs, dim=-1)
    io = lambda t: t.to(x.dtype)
    a, h1, dzp, dc = io(cat([b[0] for b in branches])), io(cat([b[1] for b in branches])), cat(dzps), cat(dcs)
    if x.dtype != torch.bfloat16:
        return io(dx), BackwardBuffers(a=a, h1=h1, dzp=dzp, dc=dc, dz=dz, u=io(u), gv=gv)
    dh = res_scale * dzp  # the TPU kernel's dh_c, which rounds as one operand
    return io(dx), BackwardBuffers(a=a, h1=h1, dzp=io(dh), dc=io(dc), dz=io(dz), u=io(u), gv=io(gv),
                                   bias=bias_partials(dz, dc, dh, gv))


def weight_grad_reduce_reference(x: torch.Tensor, bufs: BackwardBuffers, kernels: Sequence[int],
                                 dilations: Sequence[int], res_scale: float = 1.0) -> GatedHiFiWeights:
    """Plain version of the weight-gradient reduction: each gradient is a
    product of two [B*T, .] operands summed over time (one tap at a time
    for the convs, the conv input shifted by the tap's offset). bf16: both
    operands rounded to bf16 (dh = scale * dzp before it rounds, as the TPU
    kernel's dW1), the sums fp32, each gradient cast to bf16 once: the bf16
    buffers come rounded with dzp as dh already, and the bias gradients are
    the partials' sums over the frame tiles. fp32: the bias gradients are
    the buffers' column sums."""
    W = x.shape[-1]
    H = 2 * W
    bf16 = x.dtype == torch.bfloat16
    rnd = round_bf16 if bf16 else same
    outer = lambda p, q: torch.einsum("btm,btn->mn", rnd(p), rnd(q))
    ks, cbs, w1s, b1s = [], [], [], []
    for d, (k, dil) in enumerate(zip(kernels, dilations)):
        cols = slice(d * H, (d + 1) * H)
        a, dc, dzp = bufs.a[..., cols], bufs.dc[..., cols], bufs.dzp[..., cols]
        half = (k - 1) // 2
        ks.append(torch.stack([outer(_shift_time(a, (j - half) * dil), dc) for j in range(k)]))
        dh = dzp if bf16 else res_scale * dzp  # the TPU kernel's dh_c, which rounds as one operand
        w1s.append(outer(bufs.h1[..., cols], dh))
        if not bf16:
            cbs.append(dc.sum(dim=(0, 1)))
            b1s.append(dh.sum(dim=(0, 1)))
    if bf16:
        ldw = len(kernels) * H
        ball, cb, b1, bg = torch.split(bufs.bias.sum(dim=0), [ldw, ldw, ldw, W])
        cb, b1 = cb.reshape(-1, H), b1.reshape(-1, H)
    else:
        ball, cb, b1, bg = bufs.dz.sum(dim=(0, 1)), torch.stack(cbs), torch.stack(b1s), bufs.gv.sum(dim=(0, 1))
    out = GatedHiFiWeights(
        wall=outer(x, bufs.dz), ball=ball, ks=tuple(ks), cb=cb, w1=torch.stack(w1s), b1=b1,
        wg=outer(bufs.u, bufs.gv), bg=bg, dilations=tuple(dilations))
    return _weights_from({k: v.to(x.dtype) for k, v in out.tensors().items()}, dilations) if bf16 else out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_call(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights,
                extra: Mapping[str, torch.Tensor] = {}, res_scale: float = 1.0) -> None:
    """Raises on anything the kernels do not take."""
    B, T, W = x.shape
    H = 2 * W
    depth = len(w.ks)
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("gated_hifi: the kernels are built for sm_90a (Hopper)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gated_hifi: x is {x.dtype}; the kernels take float32 or bfloat16")
    _check_dtypes(x, w, extra.get("g"))
    if x.dtype == torch.bfloat16 and res_scale != 1.0:
        raise ValueError(f"gated_hifi: the bf16 kernels take res_scale 1 (every shipped config's), got {res_scale}")
    if W != _build.GATED_HIFI_WIDTH:
        raise ValueError(f"gated_hifi: kernels are built for W={_build.GATED_HIFI_WIDTH}, got W={W}")
    if T < 1 or B < 1:
        raise ValueError(f"gated_hifi: empty input {tuple(x.shape)}")
    if any(k % 2 == 0 for k in w.kernels) or not 1 <= depth <= _build.GATED_HIFI_MAX_DEPTH:
        raise ValueError(f"gated_hifi: kernels {w.kernels} must be odd, 1..8 branches")
    shapes = {"x": (B, T, W), "wall": (W, depth * H), "ball": (depth * H,), "cb": (depth, H),
              "w1": (depth, H, H), "b1": (depth, H), "wg": (W, W), "bg": (W,),
              **{f"ks.{d}": (k, H, H) for d, k in enumerate(w.kernels)},
              **{name: (B, T, W) for name in extra}}
    for name, t in {"x": x, **w.tensors(), **extra}.items():
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"gated_hifi: {name} must be a contiguous tensor on {x.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"gated_hifi: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or lens.device != x.device or not lens.is_contiguous():
        raise ValueError("gated_hifi: lens must be a contiguous int32 [B] tensor on the input's device")
    if B > 65535:
        raise ValueError(f"gated_hifi: batch {B} > 65535, the kernels' grid limit")


def _ints(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(x, lens, w: GatedHiFiWeights, res_scale: float, p_drop: float, seed: int) -> torch.Tensor:
    _check_call(x, lens, w, res_scale=res_scale)
    B, T, W = x.shape
    H, depth = 2 * W, len(w.ks)
    out = torch.empty_like(x)
    lib = _build.build()
    common = (B, T, W, depth, _ints(w.kernels), _ints(w.dilations), float(res_scale), seed & U32,
              keep_threshold(p_drop), keep_scale(p_drop), _stream(x))
    if x.dtype == torch.bfloat16:
        # one buffer: a and h1 [B, T, depth*H], then the weights the kernel packs K-major (Wall,
        # the conv kernels and W1 transposed); zp stays on chip
        scratch = torch.empty(2 * B * T * depth * H + depth * H * (W + H) + sum(w.kernels) * H * H,
                              device=x.device, dtype=x.dtype)
        ks = (ctypes.c_void_p * depth)(*(k.data_ptr() for k in w.ks))
        rc = lib.gated_hifi_fwd_bf16(
            x.data_ptr(), lens.data_ptr(), w.wall.data_ptr(), w.ball.data_ptr(), ks, w.cb.data_ptr(),
            w.w1.data_ptr(), w.b1.data_ptr(), w.wg.data_ptr(), w.bg.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), *common)
        if rc != 0:
            raise RuntimeError(f"gated_hifi_fwd_bf16 launch failed with cudaError {rc}")
        gated_hifi.bf16_launches += 1
        return out
    ks_flat = torch.cat([k.reshape(-1) for k in w.ks])
    # the stages meet in two [B, T, depth*H] buffers: a (then zp over it) and h1
    a = torch.empty(B, T, depth * H, device=x.device, dtype=x.dtype)
    h1 = torch.empty_like(a)
    rc = lib.gated_hifi_fwd(
        x.data_ptr(), lens.data_ptr(), w.wall.data_ptr(), w.ball.data_ptr(),
        ks_flat.data_ptr(), w.cb.data_ptr(), w.w1.data_ptr(), w.b1.data_ptr(),
        w.wg.data_ptr(), w.bg.data_ptr(), a.data_ptr(), h1.data_ptr(), out.data_ptr(), *common)
    if rc != 0:
        raise RuntimeError(f"gated_hifi_fwd launch failed with cudaError {rc}")
    gated_hifi.launches += 1
    return out


def gated_hifi_backward(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights, g: torch.Tensor,
                        res_scale: float = 1.0, p_drop: float = 0.0,
                        seed: int = 0) -> Tuple[torch.Tensor, GatedHiFiWeights]:
    """The block's VJP: (dx, weight gradients) for the output cotangent ``g``,
    as ``backward_buffers`` then ``weight_grad_reduce`` (each launches its
    kernel for a CUDA tensor and runs its plain version for a CPU one)."""
    dx, bufs = backward_buffers(x, lens, w, g, res_scale, p_drop, seed)
    return dx, weight_grad_reduce(x, bufs, w.kernels, w.dilations, res_scale)


def backward_buffers(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights, g: torch.Tensor,
                     res_scale: float = 1.0, p_drop: float = 0.0,
                     seed: int = 0) -> Tuple[torch.Tensor, BackwardBuffers]:
    """dx and the ``BackwardBuffers`` of the cotangent ``g``.

    A CUDA tensor launches the tile passes, which recompute the forward from
    x and the seed: in fp32 the seven 3xTF32 tensor-core stages of
    ``csrc/gated_hifi_bwd.cu``, in bf16 the TMA-fed wgmma stages of
    ``csrc/gated_hifi_bwd_bf16.cu`` and the gate's elementwise pass (with
    fp32 scratch that lives through the call: zp / dzp [B, T, depth*H] and
    du [B, T, W]);
    ``backward_buffers.launches`` counts fp32 launches, ``.bf16_launches``
    bf16 ones. A CPU tensor runs ``backward_buffers_reference``.
    """
    if x.device.type == "cpu":
        return backward_buffers_reference(x, lens, w, g, res_scale, p_drop, seed)
    if x.device.type != "cuda":
        raise ValueError(f"backward_buffers: unsupported device {x.device}")
    _check_call(x, lens, w, {"g": g}, res_scale)
    B, T, W = x.shape
    H, depth = 2 * W, len(w.ks)
    wide = lambda dtype: torch.empty(B, T, depth * H, device=x.device, dtype=dtype)
    # transposed weights: each product of the fp32 backward reads its operand
    # along rows, as the forward's do; the bf16 one reads every weight as a
    # K-major wgmma operand, the recompute's transposed and the rest as stored
    ks_flat = torch.cat([k.reshape(-1) for k in w.ks])
    ks_t = torch.cat([k.transpose(1, 2).reshape(-1) for k in w.ks])
    w1_t = w.w1.transpose(1, 2).contiguous()
    wall_t = w.wall.t().contiguous()
    dx = torch.empty_like(x)
    lib = _build.build()
    common = (B, T, W, depth, _ints(w.kernels), _ints(w.dilations), float(res_scale),
              seed & U32, keep_threshold(p_drop), keep_scale(p_drop), _stream(x))
    if x.dtype == torch.bfloat16:
        bufs = BackwardBuffers(a=wide(x.dtype), h1=wide(x.dtype), dzp=wide(x.dtype), dc=wide(x.dtype),
                               dz=wide(x.dtype), u=torch.empty_like(x), gv=torch.empty_like(x),
                               bias=torch.empty(B * -(-T // BIAS_TILE), 3 * depth * H + W, device=x.device,
                                                dtype=torch.float32))
        zp, du = wide(torch.float32), torch.empty_like(x, dtype=torch.float32)
        rc = lib.gated_hifi_bwd_bf16(
            x.data_ptr(), lens.data_ptr(), g.data_ptr(), w.wall.data_ptr(), w.ball.data_ptr(),
            ks_flat.data_ptr(), w.cb.data_ptr(), w.w1.data_ptr(), w.b1.data_ptr(), w.wg.data_ptr(),
            w1_t.data_ptr(), ks_t.data_ptr(), wall_t.data_ptr(), bufs.a.data_ptr(), bufs.h1.data_ptr(),
            zp.data_ptr(), du.data_ptr(), bufs.dzp.data_ptr(), bufs.dc.data_ptr(), bufs.dz.data_ptr(), bufs.u.data_ptr(),
            bufs.gv.data_ptr(), bufs.bias.data_ptr(), dx.data_ptr(), *common)
        if rc != 0:
            raise RuntimeError(f"gated_hifi_bwd_bf16 launch failed with cudaError {rc}")
        backward_buffers.bf16_launches += 1
        return dx, bufs
    f32 = torch.float32
    bufs = BackwardBuffers(a=wide(x.dtype), h1=wide(x.dtype), dzp=wide(f32), dc=wide(f32), dz=wide(f32),
                           u=torch.empty_like(x), gv=torch.empty_like(x, dtype=f32))
    wg_t = w.wg.t().contiguous()
    rc = lib.gated_hifi_bwd(
        x.data_ptr(), lens.data_ptr(), g.data_ptr(), w.wall.data_ptr(), w.ball.data_ptr(),
        ks_flat.data_ptr(), w.cb.data_ptr(), w.w1.data_ptr(), w.b1.data_ptr(), wg_t.data_ptr(),
        w1_t.data_ptr(), ks_t.data_ptr(), wall_t.data_ptr(),
        bufs.a.data_ptr(), bufs.h1.data_ptr(), bufs.dzp.data_ptr(), bufs.dc.data_ptr(),
        bufs.dz.data_ptr(), bufs.u.data_ptr(), bufs.gv.data_ptr(), dx.data_ptr(), *common)
    if rc != 0:
        raise RuntimeError(f"gated_hifi_bwd launch failed with cudaError {rc}")
    backward_buffers.launches += 1
    return dx, bufs


def weight_grad_reduce(x: torch.Tensor, bufs: BackwardBuffers, kernels: Sequence[int],
                       dilations: Sequence[int], res_scale: float = 1.0) -> GatedHiFiWeights:
    """The block's weight gradients from the backward's buffers.

    A CUDA tensor launches a split-over-frames reduction (per-block partial
    sums over a slice of the B*T frames, tensor-core products with the
    frames as their depth, then a second pass that adds the slices in a
    fixed order: no float atomics, so equal inputs give bitwise-equal
    gradients): in fp32 ``csrc/gated_hifi_bwd.cu``'s on 3xTF32, in bf16
    ``csrc/gated_hifi_bwd_bf16.cu``'s on TMA-fed wgmma over the bf16
    buffers, with the bias gradients from ``bufs.bias``, each gradient
    rounded once. A CPU tensor runs ``weight_grad_reduce_reference``.
    ``weight_grad_reduce.launches`` counts fp32 launches, ``.bf16_launches``
    bf16 ones.
    """
    if x.device.type == "cpu":
        return weight_grad_reduce_reference(x, bufs, kernels, dilations, res_scale)
    B, T, W = x.shape
    H, depth = 2 * W, len(kernels)
    bf16 = x.dtype == torch.bfloat16
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"weight_grad_reduce: x must be contiguous float32 or bfloat16, got {x.dtype}")
    if bf16 and res_scale != 1.0:
        raise ValueError(f"weight_grad_reduce: the bf16 kernels take res_scale 1, got {res_scale}")
    for name in ("a", "h1", "dzp", "dc", "dz", "u", "gv"):
        t = getattr(bufs, name)
        want = (B, T, W) if name in ("u", "gv") else (B, T, depth * H)
        dtype = x.dtype if bf16 or name in ("a", "h1", "u") else torch.float32
        if t.dtype != dtype or not t.is_contiguous() or t.device != x.device or t.shape != want:
            raise ValueError(f"weight_grad_reduce: {name} must be contiguous {dtype} {want} on {x.device}")
    bias_shape = (B * -(-T // BIAS_TILE), 3 * depth * H + W)
    if bf16 and (bufs.bias is None or bufs.bias.dtype != torch.float32 or not bufs.bias.is_contiguous()
                 or bufs.bias.device != x.device or tuple(bufs.bias.shape) != bias_shape):
        raise ValueError(f"weight_grad_reduce: bias must be contiguous float32 {bias_shape} on {x.device}")
    lib = _build.build()
    sizes = [W * depth * H, depth * H, sum(kernels) * H * H, depth * H, depth * H * H, depth * H, W * W, W]
    flat = torch.empty(sum(sizes), device=x.device, dtype=x.dtype)
    if bf16:
        n_floats = lib.gated_hifi_wgrad_bf16_partial_floats(B, T, depth, _ints(kernels))
        if n_floats < 1:
            raise RuntimeError("gated_hifi_wgrad_bf16_partial_floats failed")
        partials = torch.empty(n_floats, device=x.device, dtype=torch.float32)
        rc = lib.gated_hifi_wgrad_bf16(
            x.data_ptr(), bufs.a.data_ptr(), bufs.h1.data_ptr(), bufs.dzp.data_ptr(), bufs.dc.data_ptr(),
            bufs.dz.data_ptr(), bufs.u.data_ptr(), bufs.gv.data_ptr(), bufs.bias.data_ptr(), partials.data_ptr(),
            flat.data_ptr(), B, T, W, depth, _ints(kernels), _ints(dilations), float(res_scale), _stream(x))
        if rc != 0:
            raise RuntimeError(f"gated_hifi_wgrad_bf16 launch failed with cudaError {rc}")
        weight_grad_reduce.bf16_launches += 1
    else:
        n_split = lib.gated_hifi_wgrad_splits(B * T, depth, _ints(kernels))
        if n_split < 1:
            raise RuntimeError("gated_hifi_wgrad_splits failed")
        partials = torch.empty(lib.gated_hifi_wgrad_partial_floats(depth, _ints(kernels), n_split),
                               device=x.device, dtype=torch.float32)
        rc = lib.gated_hifi_wgrad(
            x.data_ptr(), bufs.a.data_ptr(), bufs.h1.data_ptr(), bufs.dzp.data_ptr(), bufs.dc.data_ptr(),
            bufs.dz.data_ptr(), bufs.u.data_ptr(), bufs.gv.data_ptr(), partials.data_ptr(),
            flat.data_ptr(), B, T, W, depth, _ints(kernels), _ints(dilations), float(res_scale),
            n_split, _stream(x))
        if rc != 0:
            raise RuntimeError(f"gated_hifi_wgrad launch failed with cudaError {rc}")
        weight_grad_reduce.launches += 1
    wall, ball, ks, cb, w1, b1, wg, bg = torch.split(flat, sizes)
    ks = torch.split(ks, [k * H * H for k in kernels])
    return GatedHiFiWeights(
        wall=wall.view(W, depth * H), ball=ball, ks=tuple(k.view(-1, H, H) for k in ks),
        cb=cb.view(depth, H), w1=w1.view(depth, H, H), b1=b1.view(depth, H), wg=wg.view(W, W),
        bg=bg, dilations=tuple(dilations))


class GatedHiFiFunction(torch.autograd.Function):
    """The block with the TPU kernel's custom VJP: a backward that saves only
    x, lens, the weights and the seed and recomputes the rest. On the card
    the forward and backward kernels; for a CPU tensor (bf16 mode) the plain
    versions. dx comes back in x's dtype, the weight gradients in the
    weights'."""

    @staticmethod
    def forward(ctx, x, lens, dilations, res_scale, p_drop, seed,
                wall, ball, cb, w1, b1, wg, bg, *ks):  # pylint: disable=arguments-differ
        w = GatedHiFiWeights(wall, ball, tuple(ks), cb, w1, b1, wg, bg, tuple(dilations))
        ctx.save_for_backward(x, lens, wall, ball, cb, w1, b1, wg, bg, *ks)
        ctx.meta = (tuple(dilations), res_scale, p_drop, seed)
        if x.device.type == "cpu":
            return gated_hifi_reference(x, lens, w, res_scale, p_drop, seed)
        return _launch_fwd(x, lens, w, res_scale, p_drop, seed)

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        x, lens, wall, ball, cb, w1, b1, wg, bg, *ks = ctx.saved_tensors
        dilations, res_scale, p_drop, seed = ctx.meta
        w = GatedHiFiWeights(wall, ball, tuple(ks), cb, w1, b1, wg, bg, dilations)
        dx, dw = gated_hifi_backward(x, lens, w, g.contiguous(), res_scale, p_drop, seed)
        return (dx, None, None, None, None, None,
                dw.wall, dw.ball, dw.cb, dw.w1, dw.b1, dw.wg, dw.bg, *dw.ks)


def gated_hifi(x: torch.Tensor, lens: torch.Tensor, w: GatedHiFiWeights,
               res_scale: float = 1.0, p_drop: float = 0.0, seed: int = 0) -> torch.Tensor:
    """GatedHiFi block forward; same contract as ``gated_hifi_reference``.

    A CUDA tensor runs ``GatedHiFiFunction`` (fp32: ``csrc/gated_hifi_fwd.cu``,
    four 3xTF32 tensor-core stages; bf16: ``csrc/gated_hifi_fwd_bf16.cu``, the
    bf16 backward's expand stage, a conv stage that sums each k-slice in
    fp32, then one stage that keeps zp on chip through the gate and u Wg, on
    TMA-fed wgmma; both meet in two scratch
    buffers of [B, T, depth*2W] in x's dtype, allocated by the wrapper (in
    bf16 with the weights transposed K-major beside them);
    differentiable through ``gated_hifi_backward``), and anything the kernels
    do not take raises. An fp32 (or fp64) CPU tensor
    runs the plain version, which autograd differentiates; a bf16 CPU tensor
    runs ``GatedHiFiFunction`` over the plain versions (the TPU kernel's
    backward rounding). ``gated_hifi.launches`` counts fp32 forward kernel
    launches, ``gated_hifi.bf16_launches`` bf16 ones.
    """
    if x.device.type == "cpu" and x.dtype != torch.bfloat16:
        return gated_hifi_reference(x, lens, w, res_scale, p_drop, seed)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gated_hifi: unsupported device {x.device}")
    keep_threshold(p_drop)
    return GatedHiFiFunction.apply(x, lens, w.dilations, float(res_scale), float(p_drop), int(seed),
                                   w.wall, w.ball, w.cb, w.w1, w.b1, w.wg, w.bg, *w.ks)


# launches of the fp32 kernels and of the bf16 ones
gated_hifi.launches = gated_hifi.bf16_launches = 0
backward_buffers.launches = backward_buffers.bf16_launches = 0
weight_grad_reduce.launches = weight_grad_reduce.bf16_launches = 0
