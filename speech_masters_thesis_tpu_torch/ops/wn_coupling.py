"""The Glow-TTS coupling conditioner: plain PyTorch versions of its forward
and recompute backward, and the kernel wrappers (counterpart of
speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, ``fused_wn_coupling``
and its custom VJP).

The CUDA kernels are ``csrc/wn_coupling_fwd.cu`` and
``csrc/wn_coupling_bwd.cu`` (fp32), and for bf16 ``csrc/wn_coupling_bf16.cu``
(TMA and wgmma; the forward is the backward's recompute, launch for launch;
their scratch is ``fwd16_layout`` and ``bwd16_layout``, one allocation a
call). ``wn_coupling`` runs ``WNCouplingFunction``: for a CUDA tensor its
forward launches the forward kernel (one call: a packing launch, for fp32
only for k > 1, then 2 + 2 * n_layers product launches) and its backward
the backward kernels, or raises; for a CPU tensor the same Function runs
``wn_coupling_reference`` and ``wn_coupling_backward_reference``. The
forward saves the inputs, the lengths, the weights and the seed, no
activations: the backward recomputes them, as the TPU kernel does.

The conditioner: start 1x1, n_layers x (dilated conv -> dropout -> tanh *
sigmoid gate -> res/skip 1x1), end 1x1, with the start output, each residual
and the skip sum masked by the lengths. Dropout (``p_drop > 0``) keeps an
element of layer i's conv output ``x_in`` [B, T, 2H] when its 32-bit draw
(``ops/hash.py``) under stream b * WN_STREAMS + i, counter t * 2H + c is >=
int(p * 2^32), and scales it by 1/(1-p): kernel and plain version agree bit
for bit, and the backward regenerates the masks from the seed (an int64
[1] tensor on the inputs' device, so a seed drawn on the card never waits
for the host).

Weights are post-weight-norm, in PyTorch's Conv1d layout [out, in, k]; the
gradients are of those weights, and autograd carries them back through the
weight norm (``flows.WNConv1d.weight``), as the JAX package does.

Two modes, as the TPU kernel's ``dot_dtype`` (x0's dtype) has them. fp32:
x0, the weights and g float32, every product in 3xTF32. bf16 (the JAX
package's mixed-precision training): x0, every weight and g bfloat16, each
product's operands rounded to bf16 where the TPU kernel's ``_dot`` casts
them and summed in fp32, everything between the products (biases, dropout,
the gate, the residual, the skip sum, the backward's scratch) fp32; out and
dx0 come out in bf16, the weight gradients summed in fp32 and cast to bf16
once (``_vjp_bwd``). Mixed dtypes raise. ``.launches`` counts fp32 kernel
launches, ``.bf16_launches`` bf16 ones. A bf16 CPU tensor runs
``WNCouplingFunction`` over the plain versions, whose backward rounds where
the TPU kernel's does (autograd through the rounded plain forward would
round cotangents it does not).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import pointwise, round_bf16, same, sequence_mask
from speech_masters_thesis_tpu_torch.ops.hash import keep_factor, keep_scale, keep_threshold

WN_STREAMS = 64  # hash streams per sequence: one per layer (csrc/wn_coupling_common.cuh)


@dataclass(frozen=True)
class WNWeights:
    """A conditioner's weights: start [H, half, 1], per layer in [2H, H, k]
    and res/skip [2H or H, H, 1] (the last layer's is H), end [C, H, 1],
    each with its bias; ``dilations`` per layer. ``cached``: the weight
    norm comes from the flow cache (inference only)."""

    ws: torch.Tensor
    bs: torch.Tensor
    win: Tuple[torch.Tensor, ...]
    bin: Tuple[torch.Tensor, ...]
    wrs: Tuple[torch.Tensor, ...]
    brs: Tuple[torch.Tensor, ...]
    wend: torch.Tensor
    bend: torch.Tensor
    dilations: Tuple[int, ...]
    cached: bool = False

    @property
    def hidden(self) -> int:
        return self.ws.shape[0]

    @property
    def kernel_size(self) -> int:
        return self.win[0].shape[2]

    def flat(self) -> Tuple[torch.Tensor, ...]:
        """ws, bs, win..., bin..., wrs..., brs..., wend, bend."""
        return (self.ws, self.bs, *self.win, *self.bin, *self.wrs, *self.brs, self.wend, self.bend)

    def tensors(self) -> Dict[str, torch.Tensor]:
        out = {"ws": self.ws, "bs": self.bs, "wend": self.wend, "bend": self.bend}
        for name in ("win", "bin", "wrs", "brs"):
            out.update({f"{name}{i}": t for i, t in enumerate(getattr(self, name))})
        return out

    @staticmethod
    def from_flat(tensors, dilations: Tuple[int, ...]) -> "WNWeights":
        L = len(dilations)
        t = list(tensors)
        return WNWeights(ws=t[0], bs=t[1], win=tuple(t[2:2 + L]), bin=tuple(t[2 + L:2 + 2 * L]),
                         wrs=tuple(t[2 + 2 * L:2 + 3 * L]), brs=tuple(t[2 + 3 * L:2 + 4 * L]),
                         wend=t[2 + 4 * L], bend=t[3 + 4 * L], dilations=tuple(dilations))


def keep_mask(seed, lens: torch.Tensor, T: int, layer: int, channels: int, p_drop: float,
              dtype=torch.float32) -> torch.Tensor:
    """Layer ``layer``'s dropout factors [B, T, channels] (0 or 1/(1-p))."""
    device = lens.device
    B = lens.shape[0]
    streams = torch.arange(B, dtype=torch.int64, device=device) * WN_STREAMS + layer
    counter = (torch.arange(T, dtype=torch.int64, device=device)[:, None] * channels
               + torch.arange(channels, dtype=torch.int64, device=device)[None, :])
    return keep_factor(seed, streams[:, None, None], counter[None], p_drop, dtype)


def _dilated(h: torch.Tensor, w: torch.Tensor, b, dil: int) -> torch.Tensor:
    k = w.shape[2]
    return F.conv1d(h.transpose(1, 2), w, b, padding=(k - 1) // 2 * dil, dilation=dil).transpose(1, 2)


def check_dtypes(x0: torch.Tensor, w: WNWeights, g: torch.Tensor | None = None) -> None:
    """x0, every weight (and g) share one dtype: one mode per call."""
    for name, t in {**w.tensors(), **({} if g is None else {"g": g})}.items():
        if t.dtype != x0.dtype:
            raise ValueError(f"wn_coupling: {name} is {t.dtype} but x0 is {x0.dtype}: x0, every weight and g "
                             "share one dtype (float32 or bfloat16)")


def _operands(x0: torch.Tensor, w: WNWeights):
    """(round, x0, w) for the plain versions: in bf16 mode x0 and w in fp32
    and ``round`` rounding a product operand to bf16; otherwise as they are
    and no rounding."""
    check_dtypes(x0, w)
    if x0.dtype != torch.bfloat16:
        return same, x0, w
    return round_bf16, x0.float(), WNWeights.from_flat([t.float() for t in w.flat()], w.dilations)


def _recompute(x0, lens, w: WNWeights, seed, p_drop: float, rnd=same):
    """The forward, keeping each layer's input h_i, post-dropout x_in_i and
    gate output; returns (valid, hs, xins, acts, skip). ``rnd`` rounds each
    product's operands (``_operands``)."""
    H, L = w.hidden, len(w.win)
    T = x0.shape[1]
    valid = sequence_mask(lens, T).to(x0.dtype)[..., None]
    h = pointwise(rnd(x0), rnd(w.ws), w.bs) * valid
    skip = torch.zeros_like(h)
    hs, xins, acts_all = [], [], []
    for i in range(L):
        hs.append(h)
        x_in = _dilated(rnd(h), rnd(w.win[i]), w.bin[i], w.dilations[i])
        if p_drop > 0.0:
            x_in = x_in * keep_mask(seed, lens, T, i, 2 * H, p_drop, x0.dtype)
        xins.append(x_in)
        acts = torch.tanh(x_in[..., :H]) * torch.sigmoid(x_in[..., H:])
        acts_all.append(acts)
        rs = pointwise(rnd(acts), rnd(w.wrs[i]), w.brs[i])
        if i < L - 1:
            h = (h + rs[..., :H]) * valid
            skip = skip + rs[..., H:]
        else:
            skip = skip + rs
    return valid, hs, xins, acts_all, skip


def recomputed_buffers(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, seed=0,
                       p_drop: float = 0.0) -> Dict[str, torch.Tensor]:
    """{"xin": each layer's post-dropout conv output [L, B, T, 2H], "skip":
    the skip sum [B, T, H]} as the plain recompute forms them (fp32, the
    products' operands rounded in bf16)."""
    rnd, xf, wf = _operands(x0, w)
    _, _, xins, _, skip = _recompute(xf, lens, wf, seed, p_drop, rnd)
    return {"xin": torch.stack(xins), "skip": skip}


def wn_coupling_reference(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, seed=0,
                          p_drop: float = 0.0) -> torch.Tensor:
    """Plain conditioner: x0 [B, T, half], lens [B] -> [B, T, C] in x0's
    dtype (bf16: the products' operands rounded as the TPU kernel rounds
    them, the rest fp32, the output rounded)."""
    rnd, xf, wf = _operands(x0, w)
    valid, _, _, _, skip = _recompute(xf, lens, wf, seed, p_drop, rnd)
    return pointwise(rnd(skip * valid), rnd(wf.wend), wf.bend).to(x0.dtype)


def _shift_rows(x: torch.Tensor, shift: int) -> torch.Tensor:
    """out[:, t] = x[:, t + shift], zero where t + shift leaves [0, T)."""
    T = x.shape[1]
    out = torch.zeros_like(x)
    if abs(shift) < T:
        if shift >= 0:
            out[:, :T - shift] = x[:, shift:]
        else:
            out[:, -shift:] = x[:, :T + shift]
    return out


def dilated_weight_grad(h: torch.Tensor, dz: torch.Tensor, k: int, dil: int) -> torch.Tensor:
    """Weight gradient [N, C, k] of a SAME dilated conv of h [B, T, C] whose
    output has cotangent dz [B, T, N]."""
    pad = (k - 1) // 2 * dil
    return torch.stack([torch.einsum("btn,btc->nc", dz, _shift_rows(h, j * dil - pad)) for j in range(k)], dim=2)


def dilated_transpose(dz: torch.Tensor, w: torch.Tensor, dil: int) -> torch.Tensor:
    """Input gradient [B, T, C] of a SAME dilated conv (weight [N, C, k])."""
    k = w.shape[2]
    return F.conv_transpose1d(dz.transpose(1, 2), w, padding=(k - 1) // 2 * dil, dilation=dil).transpose(1, 2)


def wn_coupling_backward_reference(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, g: torch.Tensor,
                                   seed=0, p_drop: float = 0.0) -> Tuple[torch.Tensor, WNWeights]:
    """Plain recompute backward, by the TPU kernel's formulas
    (``_conditioner_bwd``): (dx0 [B, T, half], the weights' gradients), in
    x0's and the weights' dtype (bf16: each product's operands rounded, the
    rest fp32, the gradients summed in fp32 and rounded once)."""
    check_dtypes(x0, w, g)
    dx0, grads = conditioner_backward(x0, lens, w, g, seed, p_drop)
    return dx0.to(x0.dtype), WNWeights.from_flat([t.to(x0.dtype) for t in grads.flat()], w.dilations)


def conditioner_backward(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, g: torch.Tensor,
                         seed=0, p_drop: float = 0.0) -> Tuple[torch.Tensor, WNWeights]:
    """``wn_coupling_backward_reference`` before its outputs' cast: dx0 and
    the gradients in fp32 (or fp64) sums, as the TPU kernel's
    ``_conditioner_bwd`` hands them on (the flow step adds g_xc to this dx0
    in fp32)."""
    H, L = w.hidden, len(w.win)
    rnd, x0, w = _operands(x0, w)
    g = g.to(x0.dtype)
    with torch.no_grad():
        valid, hs, xins, acts_all, skip = _recompute(x0, lens, w, seed, p_drop, rnd)
        T = x0.shape[1]
        dwend = torch.einsum("btc,bth->ch", rnd(g), rnd(skip * valid))[..., None]
        dbend = g.sum(dim=(0, 1))
        dskip = (rnd(g) @ rnd(w.wend[:, :, 0])) * valid
        dwin, dbin, dwrs, dbrs = [None] * L, [None] * L, [None] * L, [None] * L
        dx_next = torch.zeros_like(skip)
        for i in reversed(range(L)):
            x_in = xins[i]
            t, s = torch.tanh(x_in[..., :H]), torch.sigmoid(x_in[..., H:])
            if i < L - 1:
                dres = dx_next * valid
                drs = torch.cat([dres, dskip], dim=-1)
                dx_i = dres
            else:
                drs = dskip
                dx_i = torch.zeros_like(dskip)
            dwrs[i] = torch.einsum("btn,bth->nh", rnd(drs), rnd(acts_all[i]))[..., None]
            dbrs[i] = drs.sum(dim=(0, 1))
            dacts = rnd(drs) @ rnd(w.wrs[i][:, :, 0])
            dxin = torch.cat([dacts * s * (1.0 - t * t), dacts * t * s * (1.0 - s)], dim=-1)
            if p_drop > 0.0:
                dxin = dxin * keep_mask(seed, lens, T, i, 2 * H, p_drop, x0.dtype)
            k, dil = w.win[i].shape[2], w.dilations[i]
            dwin[i] = dilated_weight_grad(rnd(hs[i]), rnd(dxin), k, dil)
            dbin[i] = dxin.sum(dim=(0, 1))
            dx_next = dx_i + dilated_transpose(rnd(dxin), rnd(w.win[i]), dil)
        dh = dx_next * valid
        dws = torch.einsum("bth,btc->hc", rnd(dh), rnd(x0))[..., None]
        dbs = dh.sum(dim=(0, 1))
        dx0 = rnd(dh) @ rnd(w.ws[:, :, 0])
    return dx0, WNWeights(ws=dws, bs=dbs, win=tuple(dwin), bin=tuple(dbin), wrs=tuple(dwrs), brs=tuple(dbrs),
                          wend=dwend, bend=dbend, dilations=w.dilations)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_call(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, seed: torch.Tensor) -> None:
    B, T, half = x0.shape
    H, L, k = w.hidden, len(w.win), w.kernel_size
    if torch.cuda.get_device_capability(x0.device) != (9, 0):
        raise RuntimeError("wn_coupling: the kernels are built for sm_90a (Hopper)")
    if B < 1 or T < 1 or k not in (1, 3, 5) or not 1 <= L <= WN_STREAMS:
        raise ValueError(f"wn_coupling: input {tuple(x0.shape)}, kernel {k} (1, 3 or 5), {L} layers")
    if x0.dtype not in (torch.float32, torch.bfloat16) or x0.stride(2) != 1 or x0.stride(0) != T * x0.stride(1):
        raise ValueError("wn_coupling: x0 must be float32 or bfloat16 [B, T, half] with unit channel stride and "
                         f"rows of one stride; got {x0.dtype}, strides {x0.stride()}")
    check_dtypes(x0, w)
    C = w.wend.shape[0]
    shapes = {"ws": (H, half, 1), "bs": (H,), "wend": (C, H, 1), "bend": (C,)}
    for i in range(L):
        rs = 2 * H if i < L - 1 else H
        shapes.update({f"win{i}": (2 * H, H, k), f"bin{i}": (2 * H,), f"wrs{i}": (rs, H, 1), f"brs{i}": (rs,)})
    for name, t in w.tensors().items():
        if not t.is_contiguous() or t.device != x0.device:
            raise ValueError(f"wn_coupling: {name} must be a contiguous {x0.dtype} tensor on {x0.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"wn_coupling: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or lens.device != x0.device or not lens.is_contiguous():
        raise ValueError("wn_coupling: lens must be a contiguous int32 [B] tensor on the input's device")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != x0.device:
        raise ValueError("wn_coupling: seed must be an int64 tensor of one element on the input's device")
    if tuple(w.dilations) != tuple(_rate(w) ** i for i in range(L)):
        raise ValueError(f"wn_coupling: dilations {w.dilations} must be rate ** layer")


def _rate(w: WNWeights) -> int:
    return w.dilations[1] if len(w.dilations) > 1 else 1


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _shape_args(x0: torch.Tensor, w: WNWeights) -> tuple:
    B, T, half = x0.shape
    return B, T, half, w.hidden, w.wend.shape[0], len(w.win), w.kernel_size, _rate(w)


def _dropout_args(p_drop: float) -> tuple:
    return keep_threshold(p_drop), keep_scale(p_drop)


# ---------------------------------------------------------------------------
# the bf16 backward's scratch (csrc/wn_coupling_bf16.cu, B3's and B6's)
# ---------------------------------------------------------------------------
# The parts in the order the kernels take their pointers: the products' bf16
# operands (x0 and g packed, each layer's h, acts, dh and dx_in, skip * valid,
# dskip), the fp32 values fp32 work reads (x_in, the residual chains of h and
# dh, the skip sum), the packed weights, B6's x1, dxc, mt^T's first half rows
# and mt, then the fp32 partials of the bias and weight-gradient sums.
BWD16_PARTS = ("x0", "g", "h", "acts", "skip", "dskip", "dh", "dxin", "xin", "h32", "skip32", "dh32", "w_s",
               "w_s_t", "w_end_t", "w_in", "w_in_t", "w_rs", "w_rs_t", "x1", "dxc", "mt_t", "mt", "bias_part",
               "wsum_part")
BWD16_ALIGN = 1024  # bytes: every part starts on this boundary of the one allocation
BWD16_TILE = 64     # frames of a product's tile: a row of the bias partials


class Part(NamedTuple):
    """A part of the scratch: its byte offset, shape (a bf16 operand's last
    dimension padded to pitch8 of its channels) and dtype; ``tma``: TMA reads
    it, so its base and row stride must be multiples of 16 bytes."""

    offset: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    tma: bool

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def pitch8(channels: int) -> int:
    """Elements of a padded bf16 row: the next multiple of 8 (16 bytes)."""
    return -(-channels // 8) * 8


@functools.lru_cache(maxsize=64)
def bwd16_layout(B: int, T: int, half: int, H: int, c_out: int, n_layers: int, kernel_size: int, flow: bool,
                 wsum_floats: int) -> Dict[str, Part]:
    """The bf16 backward's scratch in one allocation, BWD16_PARTS in order,
    each part BWD16_ALIGN-aligned; B6's parts (``flow``) empty for B3.
    ``wsum_floats``: the weight sums' partials (the library's
    wn16_wsum_part_floats, which depends on the card's SMs). Cached: the
    caller must not change the dict."""
    L, k, C = n_layers, kernel_size, c_out
    bf, f32 = torch.bfloat16, torch.float32
    bt, lbt = (B, T), (L, B, T)
    none = (0,)
    S = 1 + 2 * L + (2 if flow else 0)  # bias sources: dskip, each dh_i and dx_in_i, B6's daln and dalb
    shapes = {
        "x0": ((*bt, pitch8(half)), bf, True), "g": ((*bt, pitch8(C)), bf, True),
        "h": ((*lbt, pitch8(H)), bf, True), "acts": ((*lbt, pitch8(H)), bf, True),
        "skip": ((*bt, pitch8(H)), bf, True), "dskip": ((*bt, pitch8(H)), bf, True),
        "dh": ((*lbt, pitch8(H)), bf, True), "dxin": ((*lbt, pitch8(2 * H)), bf, True),
        "xin": ((*lbt, 2 * H), f32, False), "h32": ((*bt, H), f32, False), "skip32": ((*bt, H), f32, False),
        "dh32": ((*bt, H), f32, False),
        "w_s": ((1, H, pitch8(half)), bf, True), "w_s_t": ((1, half, pitch8(H)), bf, True),
        "w_end_t": ((1, H, pitch8(C)), bf, True),
        "w_in": ((L * k, 64 * -(-H // 32), pitch8(H)), bf, True),  # the gate's row order: 32 tanh rows, 32 sigmoid
        "w_in_t": ((L * k, H, pitch8(2 * H)), bf, True), "w_rs": ((L, 2 * H, pitch8(H)), bf, True),
        # W_rs^T: the residual half's H columns, zeros to a multiple of 64, the skip half's H
        "w_rs_t": ((L, H, pitch8(64 * -(-H // 64) + H)), bf, True),
        "x1": ((*bt, pitch8(C)) if flow else none, bf, True), "dxc": ((*bt, pitch8(C)) if flow else none, bf, True),
        "mt_t": ((1, half, pitch8(C)) if flow else none, bf, True),
        "mt": ((1, C, pitch8(C)) if flow else none, bf, True),
        "bias_part": ((S, B * -(-T // BWD16_TILE), max(2 * H, C)), f32, False),
        "wsum_part": ((wsum_floats,), f32, False),
    }
    return _laid_out(BWD16_PARTS, shapes)


def _laid_out(names: Tuple[str, ...], shapes: dict) -> Dict[str, Part]:
    """The parts in order, each starting on a BWD16_ALIGN boundary."""
    layout, offset = {}, 0
    for name in names:
        part = Part(offset, *shapes[name])
        layout[name] = part
        offset += -(-part.nbytes // BWD16_ALIGN) * BWD16_ALIGN
    return layout


def _allocate(x: torch.Tensor, layout: Dict[str, Part], views: Tuple[Tuple[str, str], ...]):
    """(one uint8 allocation on x's device holding the layout, its parts'
    pointers in order (None for an empty part), {name: the view of part at
    its shape and dtype} for each (name, part) of views)."""
    last = layout[next(reversed(layout))]
    buf = torch.empty(last.offset + last.nbytes, dtype=torch.uint8, device=x.device)
    base = buf.data_ptr()
    ptrs = (ctypes.c_void_p * len(layout))(*[base + p.offset if p.nbytes else None for p in layout.values()])
    out = {name: buf[layout[part].offset:layout[part].offset + layout[part].nbytes].view(layout[part].dtype)
           .view(layout[part].shape) for name, part in views}
    return buf, ptrs, out


# ---------------------------------------------------------------------------
# the bf16 forward's scratch (csrc/wn_coupling_bf16.cu, B3's and B6's)
# ---------------------------------------------------------------------------
# The parts in the order the kernels take their pointers: x0 packed (B3; B6
# only where xc's rows are not 16 bytes apart, else it reads xc in place),
# h in two planes (layers alternate), acts, skip * valid, the fp32 residual
# chain of h and skip sum, x_in (only when the caller reads it back), the
# packed W_s, W_in (the gate's row order), W_rs and W_end, B6's x1 and mt^T.
FWD16_PARTS = ("x0", "h", "acts", "skip", "h32", "skip32", "xin", "w_s", "w_in", "w_rs", "w_end", "x1", "mt_t")


@functools.lru_cache(maxsize=64)
def fwd16_layout(B: int, T: int, half: int, H: int, c_out: int, n_layers: int, kernel_size: int, flow: bool,
                 buffers: bool) -> Dict[str, Part]:
    """The bf16 forward's scratch in one allocation, FWD16_PARTS in order,
    each part BWD16_ALIGN-aligned; B6's parts (``flow``) empty for B3, x_in
    empty unless ``buffers`` (the wrapper's return_buffers). Cached: the
    caller must not change the dict."""
    L, k, C = n_layers, kernel_size, c_out
    bf, f32 = torch.bfloat16, torch.float32
    bt, none = (B, T), (0,)
    shapes = {
        "x0": ((*bt, pitch8(half)) if not flow or C % 8 else none, bf, True),
        "h": ((min(L, 2), *bt, pitch8(H)), bf, True), "acts": ((*bt, pitch8(H)), bf, True),
        "skip": ((*bt, pitch8(H)), bf, True), "h32": ((*bt, H), f32, False), "skip32": ((*bt, H), f32, False),
        "xin": ((L, *bt, 2 * H) if buffers else none, f32, False),
        "w_s": ((1, H, pitch8(half)), bf, True), "w_in": ((L * k, 64 * -(-H // 32), pitch8(H)), bf, True),
        "w_rs": ((L, 2 * H, pitch8(H)), bf, True), "w_end": ((1, C, pitch8(H)), bf, True),
        "x1": ((*bt, pitch8(C)) if flow else none, bf, True), "mt_t": ((1, C, pitch8(C)) if flow else none, bf, True),
    }
    return _laid_out(FWD16_PARTS, shapes)


def fwd16_scratch(x: torch.Tensor, shape: tuple, flow: bool, buffers: bool):
    """(the one uint8 allocation, its parts' pointers in FWD16_PARTS order,
    {"xin": [L, B, T, 2H], "skip": [B, T, H]} fp32 views when ``buffers``,
    else {}) for the bf16 forward of ``shape`` (``_shape_args``)."""
    B, T, half, H, c_out, L, k, _ = shape
    layout = fwd16_layout(B, T, half, H, c_out, L, k, flow, buffers)
    return _allocate(x, layout, (("xin", "xin"), ("skip", "skip32")) if buffers else ())


def bwd16_scratch(x: torch.Tensor, shape: tuple, flow: bool):
    """(the one uint8 allocation, its parts' pointers in BWD16_PARTS order
    (None for an empty part), the recompute's buffers as ``return_buffers``
    gives them: {"xin": [L, B, T, 2H], "skip": [B, T, H]} fp32 views, for
    B6 (``flow``) also "x0": the bf16 x0 = (x1 mt)[:, :half] [B, T, half])
    for the bf16 backward of ``shape`` (``_shape_args``)."""
    lib = _build.build()
    wsum = lib.wn16_wsum_part_floats(*shape, int(flow))
    if wsum < 0:
        raise ValueError(f"wn_coupling: the bf16 backward does not take the shape {shape}")
    B, T, half, H, c_out, L, k, _ = shape
    layout = bwd16_layout(B, T, half, H, c_out, L, k, flow, wsum)
    buf, ptrs, views = _allocate(x, layout, (("xin", "xin"), ("skip", "skip32")) + ((("x0", "x0"),) if flow else ()))
    if flow:
        views["x0"] = views["x0"][..., :half]
    return buf, ptrs, views


def _launch_fwd(x0, lens, w: WNWeights, seed, p_drop: float, return_buffers: bool = False):
    """out, or with ``return_buffers`` (bf16 only) (out, the forward's
    {"xin", "skip"} as ``wn_coupling_backward`` returns the recompute's)."""
    _check_call(x0, lens, w, seed)
    B, T, _ = x0.shape
    H, C = w.hidden, w.wend.shape[0]
    bf16 = x0.dtype == torch.bfloat16
    if return_buffers and not bf16:
        raise ValueError("wn_coupling: return_buffers reads back the bf16 forward's buffers only")
    out = torch.empty(B, T, C, device=x0.device, dtype=x0.dtype)
    lib = _build.build()
    shape = _shape_args(x0, w)
    inputs = (x0.data_ptr(), x0.stride(1), lens.data_ptr(), seed.data_ptr(), w.ws.data_ptr(), w.bs.data_ptr(),
              _pointers(w.win), _pointers(w.bin), _pointers(w.wrs), _pointers(w.brs), w.wend.data_ptr(),
              w.bend.data_ptr(), out.data_ptr())
    if bf16:
        scratch, parts, bufs = fwd16_scratch(x0, shape, flow=False, buffers=return_buffers)
        rc = lib.wn_coupling_fwd_bf16(*inputs, parts, *shape, *_dropout_args(p_drop), _stream(x0))
    else:
        h, acts, skip = (torch.empty(B, T, H, device=x0.device, dtype=torch.float32) for _ in range(3))
        workspace = torch.empty(lib.wn_coupling_fwd_workspace_floats(*shape), device=x0.device, dtype=torch.float32)
        rc = lib.wn_coupling_fwd(*inputs, h.data_ptr(), acts.data_ptr(), skip.data_ptr(), workspace.data_ptr(),
                                 *shape, *_dropout_args(p_drop), _stream(x0))
    if rc != 0:
        raise RuntimeError(f"wn_coupling_fwd{'_bf16' if bf16 else ''} launch failed with cudaError {rc}")
    if bf16:
        wn_coupling.bf16_launches += 1
    else:
        wn_coupling.launches += 1
    return (out, bufs) if return_buffers else out


def wn_coupling_backward(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, g: torch.Tensor, seed,
                         p_drop: float = 0.0, return_buffers: bool = False):
    """(dx0 [B, T, half], the weights' gradients) for the output cotangent g.

    A CUDA tensor launches ``csrc/wn_coupling_bwd.cu`` (the recomputed
    forward, then per layer in reverse the gate's and the dilated conv's
    transposes, then one fixed-order reduction of every weight gradient: two
    calls are bitwise equal; every product in 3xTF32 on the tensor cores),
    or for bf16 tensors ``csrc/wn_coupling_bf16.cu`` (the same chain on
    TMA and wgmma, its scratch ``bwd16_layout`` in one allocation), and
    counts ``wn_coupling_backward.launches`` (fp32) or ``.bf16_launches``; a CPU
    tensor runs ``wn_coupling_backward_reference``. ``return_buffers``
    adds {"xin": [L, B, T, 2H], "skip": [B, T, H]}: each layer's
    post-dropout conv output and the skip sum as the kernels recomputed
    them (the plain recompute's on the CPU), fp32. The bf16 recompute runs
    the bf16 forward's launches, so these equal ``wn_coupling``'s
    ``return_buffers`` bit for bit.
    """
    if x0.device.type == "cpu":
        dx0, grads = wn_coupling_backward_reference(x0, lens, w, g, seed, p_drop)
        return (dx0, grads, recomputed_buffers(x0, lens, w, seed, p_drop)) if return_buffers else (dx0, grads)
    if x0.device.type != "cuda":
        raise ValueError(f"wn_coupling_backward: unsupported device {x0.device}")
    _check_call(x0, lens, w, seed)
    B, T, half = x0.shape
    H, L, C = w.hidden, len(w.win), w.wend.shape[0]
    bf16 = x0.dtype == torch.bfloat16
    if g.shape != (B, T, C) or g.dtype != x0.dtype or not g.is_contiguous() or g.device != x0.device:
        raise ValueError(f"wn_coupling_backward: g must be a contiguous {x0.dtype} [{B}, {T}, {C}] tensor, "
                         f"got {g.dtype}")
    dx0 = torch.empty(B, T, half, device=x0.device, dtype=x0.dtype)
    lib = _build.build()
    shape = _shape_args(x0, w)
    inputs = (x0.data_ptr(), x0.stride(1), lens.data_ptr(), seed.data_ptr(), g.data_ptr(),
              w.ws.data_ptr(), _pointers(w.win), _pointers(w.wrs), w.wend.data_ptr(),
              w.bs.data_ptr(), _pointers(w.bin), _pointers(w.brs))
    grads = WNWeights.from_flat([torch.empty_like(t) for t in w.flat()], w.dilations)
    if bf16:
        scratch, parts, bufs = bwd16_scratch(x0, shape, flow=False)
        rc = lib.wn_coupling_bwd_bf16(
            *inputs, dx0.data_ptr(), grads.ws.data_ptr(), grads.bs.data_ptr(), _pointers(grads.win),
            _pointers(grads.bin), _pointers(grads.wrs), _pointers(grads.brs), grads.wend.data_ptr(),
            grads.bend.data_ptr(), parts, *shape, *_dropout_args(p_drop), _stream(x0))
    else:
        empty = lambda *shape: torch.empty(*shape, device=x0.device, dtype=torch.float32)  # noqa: E731
        hs, acts, dh = empty(L, B, T, H), empty(L, B, T, H), empty(L, B, T, H)
        xin, dxin = empty(L, B, T, 2 * H), empty(L, B, T, 2 * H)
        skip, dskip = empty(B, T, H), empty(B, T, H)
        workspace = empty(lib.wn_coupling_bwd_workspace_floats(*shape))
        bufs = {"xin": xin, "skip": skip}
        rc = lib.wn_coupling_bwd(
            *inputs, dx0.data_ptr(), grads.ws.data_ptr(), grads.bs.data_ptr(), _pointers(grads.win),
            _pointers(grads.bin), _pointers(grads.wrs), _pointers(grads.brs), grads.wend.data_ptr(),
            grads.bend.data_ptr(), hs.data_ptr(), xin.data_ptr(), acts.data_ptr(), skip.data_ptr(),
            dskip.data_ptr(), dh.data_ptr(), dxin.data_ptr(), workspace.data_ptr(), *shape,
            *_dropout_args(p_drop), _stream(x0))
    if rc != 0:
        raise RuntimeError(f"wn_coupling_bwd{'_bf16' if bf16 else ''} launch failed with cudaError {rc}")
    if bf16:
        wn_coupling_backward.bf16_launches += 1
    else:
        wn_coupling_backward.launches += 1
    if return_buffers:
        return dx0, grads, bufs
    return dx0, grads


class WNCouplingFunction(torch.autograd.Function):
    """The conditioner with a recompute backward: saves the inputs, the
    lengths, the seed and the weights, no activations."""

    @staticmethod
    def forward(ctx, x0, lens, seed, p_drop, dilations, *weights):  # pylint: disable=arguments-differ
        w = WNWeights.from_flat(weights, dilations)
        if x0.device.type == "cpu":
            out = wn_coupling_reference(x0, lens, w, seed, p_drop)
        else:
            out = _launch_fwd(x0, lens, w, seed, p_drop)
        ctx.save_for_backward(x0, lens, seed, *weights)
        ctx.meta = (p_drop, dilations)
        return out

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        x0, lens, seed, *weights = ctx.saved_tensors
        p_drop, dilations = ctx.meta
        dx0, grads = wn_coupling_backward(x0, lens, WNWeights.from_flat(weights, dilations), g.contiguous(),
                                          seed, p_drop)
        return (dx0, None, None, None, None, *grads.flat())


def wn_coupling(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, seed=None,
                p_drop: float = 0.0, return_buffers: bool = False):
    """The conditioner; same contract as ``wn_coupling_reference``,
    differentiable in x0 and every weight through ``WNCouplingFunction``.

    A CUDA tensor launches ``csrc/wn_coupling_fwd.cu`` (x0 may be the
    first-half view of the coupling input; lens int32 [B] and seed int64 [1]
    on the same device; every product in 3xTF32 on the tensor cores), or for
    bf16 tensors ``csrc/wn_coupling_bf16.cu`` (TMA and wgmma, the bf16
    backward's recompute launches), and counts ``wn_coupling.launches``
    (fp32) or ``wn_coupling.bf16_launches``; anything the kernels do not
    take raises. A CPU tensor runs the plain versions.
    ``return_buffers`` (for tests; bf16 on the card, outside autograd)
    returns (out, {"xin", "skip"}): the forward's post-dropout conv outputs
    and skip sum as ``wn_coupling_backward`` returns the recompute's (the
    plain recompute's on the CPU).
    Weights from the flow cache are for inference: a train-mode call (with
    dropout) raises, since the cache carries no gradient back to the weight
    norm's parameters (``flows.CouplingBlock`` raises on any train-mode call
    with the cache built).
    """
    if w.cached and p_drop > 0.0:
        raise RuntimeError("wn_coupling: the flow cache's weights serve inference; clear_flow_cache before "
                           "training")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wn_coupling: unsupported device {x0.device}")
    keep_threshold(p_drop)
    check_dtypes(x0, w)
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int64, device=x0.device)
    if return_buffers:
        with torch.no_grad():
            if x0.device.type == "cpu":
                return (wn_coupling_reference(x0, lens, w, seed, p_drop),
                        recomputed_buffers(x0, lens, w, seed, p_drop))
            return _launch_fwd(x0, lens, w, seed, p_drop, return_buffers=True)
    return WNCouplingFunction.apply(x0, lens, seed, float(p_drop), tuple(w.dilations), *w.flat())


# launches of the fp32 kernels and of the bf16 ones
wn_coupling.launches = wn_coupling.bf16_launches = 0
wn_coupling_backward.launches = wn_coupling_backward.bf16_launches = 0
