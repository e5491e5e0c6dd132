"""The Glow-TTS coupling conditioner: plain PyTorch versions of its forward
and recompute backward, and the kernel wrappers (counterpart of
speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, ``fused_wn_coupling``
and its custom VJP).

The CUDA kernels are ``csrc/wn_coupling_fwd.cu`` and
``csrc/wn_coupling_bwd.cu``. ``wn_coupling`` runs ``WNCouplingFunction``:
for a CUDA tensor its forward launches the forward kernel (one call: a
weight packing launch for k > 1, then 2 + 2 * n_layers launches of the
tensor-core convolution) and its backward the backward kernels, or raises; for a CPU tensor the same Function runs
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
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import pointwise, sequence_mask
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


def _recompute(x0, lens, w: WNWeights, seed, p_drop: float):
    """The forward, keeping each layer's input h_i, post-dropout x_in_i and
    gate output; returns (valid, hs, xins, acts, skip)."""
    H, L = w.hidden, len(w.win)
    T = x0.shape[1]
    valid = sequence_mask(lens, T).to(x0.dtype)[..., None]
    h = pointwise(x0, w.ws, w.bs) * valid
    skip = torch.zeros_like(h)
    hs, xins, acts_all = [], [], []
    for i in range(L):
        hs.append(h)
        x_in = _dilated(h, w.win[i], w.bin[i], w.dilations[i])
        if p_drop > 0.0:
            x_in = x_in * keep_mask(seed, lens, T, i, 2 * H, p_drop, x0.dtype)
        xins.append(x_in)
        acts = torch.tanh(x_in[..., :H]) * torch.sigmoid(x_in[..., H:])
        acts_all.append(acts)
        rs = pointwise(acts, w.wrs[i], w.brs[i])
        if i < L - 1:
            h = (h + rs[..., :H]) * valid
            skip = skip + rs[..., H:]
        else:
            skip = skip + rs
    return valid, hs, xins, acts_all, skip


def wn_coupling_reference(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, seed=0,
                          p_drop: float = 0.0) -> torch.Tensor:
    """Plain conditioner: x0 [B, T, half], lens [B] -> [B, T, C]."""
    valid, _, _, _, skip = _recompute(x0, lens, w, seed, p_drop)
    return pointwise(skip * valid, w.wend, w.bend)


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
    (``_conditioner_bwd``): (dx0 [B, T, half], the weights' gradients)."""
    H, L = w.hidden, len(w.win)
    with torch.no_grad():
        valid, hs, xins, acts_all, skip = _recompute(x0, lens, w, seed, p_drop)
        T = x0.shape[1]
        dwend = torch.einsum("btc,bth->ch", g, skip * valid)[..., None]
        dbend = g.sum(dim=(0, 1))
        dskip = (g @ w.wend[:, :, 0]) * valid
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
            dwrs[i] = torch.einsum("btn,bth->nh", drs, acts_all[i])[..., None]
            dbrs[i] = drs.sum(dim=(0, 1))
            dacts = drs @ w.wrs[i][:, :, 0]
            dxin = torch.cat([dacts * s * (1.0 - t * t), dacts * t * s * (1.0 - s)], dim=-1)
            if p_drop > 0.0:
                dxin = dxin * keep_mask(seed, lens, T, i, 2 * H, p_drop, x0.dtype)
            k, dil = w.win[i].shape[2], w.dilations[i]
            dwin[i] = dilated_weight_grad(hs[i], dxin, k, dil)
            dbin[i] = dxin.sum(dim=(0, 1))
            dx_next = dx_i + dilated_transpose(dxin, w.win[i], dil)
        dh = dx_next * valid
        dws = torch.einsum("bth,btc->hc", dh, x0)[..., None]
        dbs = dh.sum(dim=(0, 1))
        dx0 = dh @ w.ws[:, :, 0]
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
    if x0.dtype != torch.float32 or x0.stride(2) != 1 or x0.stride(0) != T * x0.stride(1):
        raise ValueError("wn_coupling: x0 must be float32 [B, T, half] with unit channel stride and "
                         f"rows of one stride; got strides {x0.stride()}")
    C = w.wend.shape[0]
    shapes = {"ws": (H, half, 1), "bs": (H,), "wend": (C, H, 1), "bend": (C,)}
    for i in range(L):
        rs = 2 * H if i < L - 1 else H
        shapes.update({f"win{i}": (2 * H, H, k), f"bin{i}": (2 * H,), f"wrs{i}": (rs, H, 1), f"brs{i}": (rs,)})
    for name, t in w.tensors().items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x0.device:
            raise ValueError(f"wn_coupling: {name} must be a contiguous float32 tensor on {x0.device}")
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


def _launch_fwd(x0, lens, w: WNWeights, seed, p_drop: float) -> torch.Tensor:
    _check_call(x0, lens, w, seed)
    B, T, _ = x0.shape
    H, C = w.hidden, w.wend.shape[0]
    out = torch.empty(B, T, C, device=x0.device, dtype=torch.float32)
    h, acts, skip = (torch.empty(B, T, H, device=x0.device, dtype=torch.float32) for _ in range(3))
    lib = _build.build()
    shape = _shape_args(x0, w)
    workspace = torch.empty(lib.wn_coupling_fwd_workspace_floats(*shape), device=x0.device, dtype=torch.float32)
    rc = lib.wn_coupling_fwd(
        x0.data_ptr(), x0.stride(1), lens.data_ptr(), seed.data_ptr(), w.ws.data_ptr(), w.bs.data_ptr(),
        _pointers(w.win), _pointers(w.bin), _pointers(w.wrs), _pointers(w.brs),
        w.wend.data_ptr(), w.bend.data_ptr(), out.data_ptr(), h.data_ptr(), acts.data_ptr(), skip.data_ptr(),
        workspace.data_ptr(), *shape, *_dropout_args(p_drop), _stream(x0))
    if rc != 0:
        raise RuntimeError(f"wn_coupling_fwd launch failed with cudaError {rc}")
    wn_coupling.launches += 1
    return out


def wn_coupling_backward(x0: torch.Tensor, lens: torch.Tensor, w: WNWeights, g: torch.Tensor, seed,
                         p_drop: float = 0.0, return_buffers: bool = False):
    """(dx0 [B, T, half], the weights' gradients) for the output cotangent g.

    A CUDA tensor launches ``csrc/wn_coupling_bwd.cu`` (the recomputed
    forward, then per layer in reverse the gate's and the dilated conv's
    transposes, then one fixed-order reduction of every weight gradient: two
    calls are bitwise equal; every product in 3xTF32 on the tensor cores)
    and counts
    ``wn_coupling_backward.launches``; a CPU tensor runs
    ``wn_coupling_backward_reference``. ``return_buffers``
    adds {"xin": [L, B, T, 2H]}: each layer's post-dropout conv output as
    the kernels recomputed it (the plain recompute's on the CPU).
    """
    if x0.device.type == "cpu":
        dx0, grads = wn_coupling_backward_reference(x0, lens, w, g, seed, p_drop)
        if return_buffers:
            return dx0, grads, {"xin": torch.stack(_recompute(x0, lens, w, seed, p_drop)[2])}
        return dx0, grads
    if x0.device.type != "cuda":
        raise ValueError(f"wn_coupling_backward: unsupported device {x0.device}")
    _check_call(x0, lens, w, seed)
    B, T, half = x0.shape
    H, L, C = w.hidden, len(w.win), w.wend.shape[0]
    if g.shape != (B, T, C) or g.dtype != torch.float32 or not g.is_contiguous() or g.device != x0.device:
        raise ValueError(f"wn_coupling_backward: g must be a contiguous float32 [{B}, {T}, {C}] tensor")
    empty = lambda *shape: torch.empty(*shape, device=x0.device, dtype=torch.float32)  # noqa: E731
    dx0 = empty(B, T, half)
    grads = WNWeights.from_flat([empty(*t.shape) for t in w.flat()], w.dilations)
    hs, acts, dh = empty(L, B, T, H), empty(L, B, T, H), empty(L, B, T, H)
    xin, dxin = empty(L, B, T, 2 * H), empty(L, B, T, 2 * H)
    skip, dskip = empty(B, T, H), empty(B, T, H)
    lib = _build.build()
    shape = _shape_args(x0, w)
    workspace = empty(lib.wn_coupling_bwd_workspace_floats(*shape))
    rc = lib.wn_coupling_bwd(
        x0.data_ptr(), x0.stride(1), lens.data_ptr(), seed.data_ptr(), g.data_ptr(),
        w.ws.data_ptr(), _pointers(w.win), _pointers(w.wrs), w.wend.data_ptr(),
        w.bs.data_ptr(), _pointers(w.bin), _pointers(w.brs),
        dx0.data_ptr(), grads.ws.data_ptr(), grads.bs.data_ptr(), _pointers(grads.win), _pointers(grads.bin),
        _pointers(grads.wrs), _pointers(grads.brs), grads.wend.data_ptr(), grads.bend.data_ptr(),
        hs.data_ptr(), xin.data_ptr(), acts.data_ptr(), skip.data_ptr(), dskip.data_ptr(), dh.data_ptr(),
        dxin.data_ptr(), workspace.data_ptr(), *shape, *_dropout_args(p_drop), _stream(x0))
    if rc != 0:
        raise RuntimeError(f"wn_coupling_bwd launch failed with cudaError {rc}")
    wn_coupling_backward.launches += 1
    if return_buffers:
        return dx0, grads, {"xin": xin}
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
                p_drop: float = 0.0) -> torch.Tensor:
    """The conditioner; same contract as ``wn_coupling_reference``,
    differentiable in x0 and every weight through ``WNCouplingFunction``.

    A CUDA tensor launches ``csrc/wn_coupling_fwd.cu`` (x0 may be the
    first-half view of the coupling input; lens int32 [B] and seed int64 [1]
    on the same device; every product in 3xTF32 on the tensor cores) and
    counts ``wn_coupling.launches``; anything the kernels do not take
    raises. A CPU tensor runs the plain versions.
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
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int64, device=x0.device)
    return WNCouplingFunction.apply(x0, lens, seed, float(p_drop), tuple(w.dilations), *w.flat())


wn_coupling.launches = 0
wn_coupling_backward.launches = 0
