"""One whole Glow-TTS flow step, ActNorm -> InvConvNear -> the coupling
conditioner: plain PyTorch versions of its forward and recompute backward,
and the kernel wrappers (counterpart of
speech_masters_thesis_tpu/ops/pallas/wn_coupling.py, ``fused_flow_step`` and
its custom VJP).

For x [B, T, C] (C = 2 * half), the ActNorm's aln, alb [C] and the
InvConvNear's dense transposed matrix mt [C, C]
(``models.glow_tts.flows.InvConvNear.dense_matrix_t``):

    x1  = (alb + exp(aln) * x) * valid,   xc = x1 @ mt,
    out = the conditioner (ops/wn_coupling.py) on xc[..., :half]

and the step returns (xc, out); the logdets stay with the caller, as in the
JAX package. Dropout is the conditioner's, on its hash streams, so this route
and the conditioner-only route draw the same masks from the same seed.

The CUDA kernels are ``csrc/flow_step_fwd.cu`` and ``csrc/flow_step_bwd.cu``.
``flow_step`` runs ``FlowStepFunction``: for a CUDA tensor its forward
launches the forward kernel (one call: 3 + 2 * n_layers launches, and one
more packing the conditioner's weights for k > 1) and its
backward the backward kernels, or raises; for a CPU tensor the same Function
runs ``flow_step_reference`` and ``flow_step_backward_reference``. The
forward saves the inputs, the lengths, the seed and the weights, no
activations: the backward recomputes them, as the TPU kernel does. Its
gradients reach ``aln``, ``alb``, ``mt`` and every conditioner weight, and
autograd carries them on to the ActNorm's parameters, through
``dense_matrix_t`` to the InvConvNear's weight, and through the weight
norm.
"""

from __future__ import annotations

from typing import Tuple

import torch

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import sequence_mask
from speech_masters_thesis_tpu_torch.ops.hash import keep_threshold
from speech_masters_thesis_tpu_torch.ops.wn_coupling import (
    WNWeights,
    _check_call as _check_conditioner,
    _dropout_args,
    _pointers,
    _recompute,
    _shape_args,
    _stream,
    wn_coupling_backward_reference,
    wn_coupling_reference,
)


def _prefix(x, lens, aln, alb, mt):
    """(valid [B, T, 1], x1, xc): the ActNorm and the dense InvConvNear."""
    valid = sequence_mask(lens, x.shape[1]).to(x.dtype)[..., None]
    x1 = (alb + torch.exp(aln) * x) * valid
    return valid, x1, x1 @ mt


def flow_step_reference(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor,
                        mt: torch.Tensor, w: WNWeights, seed=0,
                        p_drop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain flow step: x [B, T, C], lens [B] -> (xc, out), both [B, T, C]."""
    xc = _prefix(x, lens, aln, alb, mt)[2]
    return xc, wn_coupling_reference(xc[..., :x.shape[2] // 2], lens, w, seed, p_drop)


def flow_step_backward_reference(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor,
                                 mt: torch.Tensor, w: WNWeights, g_xc: torch.Tensor, g_out: torch.Tensor, seed=0,
                                 p_drop: float = 0.0):
    """Plain recompute backward by the TPU kernel's formulas
    (``_bwd_flow_kernel``): (dx, daln, dalb, dmt, the conditioner weights'
    gradients) for the cotangents g_xc of xc and g_out of out."""
    half = x.shape[2] // 2
    with torch.no_grad():
        valid, x1, xc = _prefix(x, lens, aln, alb, mt)
        dx0, grads = wn_coupling_backward_reference(xc[..., :half], lens, w, g_out, seed, p_drop)
        gxc = g_xc * valid
        dxc = torch.cat([gxc[..., :half] + dx0, gxc[..., half:]], dim=-1)
        dmt = torch.einsum("btc,btn->cn", x1, dxc)
        dx1 = dxc @ mt.t()
        ex = torch.exp(aln)
        daln = (dx1 * ex * x * valid).sum(dim=(0, 1))
        dalb = (dx1 * valid).sum(dim=(0, 1))
        dx = dx1 * ex * valid
    return dx, daln, dalb, dmt, grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_call(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor, mt: torch.Tensor,
                w: WNWeights, seed: torch.Tensor) -> None:
    B, T, C = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous() or C % 2 or w.wend.shape[0] != C:
        raise ValueError(f"flow_step: x must be a contiguous float32 [B, T, C] tensor with C even and equal to "
                         f"the end conv's width; got {tuple(x.shape)}, {x.dtype}, end {tuple(w.wend.shape)}")
    for name, t, shape in (("aln", aln, (C,)), ("alb", alb, (C,)), ("mt", mt, (C, C))):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"flow_step: {name} must be a contiguous float32 {shape} tensor on {x.device}")
    _check_conditioner(x[..., :C // 2], lens, w, seed)


def _launch_fwd(x, lens, aln, alb, mt, w: WNWeights, seed, p_drop: float):
    _check_call(x, lens, aln, alb, mt, w, seed)
    B, T, C = x.shape
    H = w.hidden
    xc, out = (torch.empty(B, T, C, device=x.device, dtype=torch.float32) for _ in range(2))
    h, acts, skip = (torch.empty(B, T, H, device=x.device, dtype=torch.float32) for _ in range(3))
    lib = _build.build()
    shape = _shape_args(x[..., :C // 2], w)
    workspace = torch.empty(lib.flow_step_fwd_workspace_floats(*shape), device=x.device, dtype=torch.float32)
    rc = lib.flow_step_fwd(
        x.data_ptr(), lens.data_ptr(), seed.data_ptr(), aln.data_ptr(), alb.data_ptr(), mt.data_ptr(),
        w.ws.data_ptr(), w.bs.data_ptr(), _pointers(w.win), _pointers(w.bin), _pointers(w.wrs), _pointers(w.brs),
        w.wend.data_ptr(), w.bend.data_ptr(), xc.data_ptr(), out.data_ptr(), h.data_ptr(), acts.data_ptr(),
        skip.data_ptr(), workspace.data_ptr(), *shape, *_dropout_args(p_drop), _stream(x))
    if rc != 0:
        raise RuntimeError(f"flow_step_fwd launch failed with cudaError {rc}")
    flow_step.launches += 1
    return xc, out


def flow_step_backward(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor,
                       mt: torch.Tensor, w: WNWeights, g_xc: torch.Tensor, g_out: torch.Tensor, seed,
                       p_drop: float = 0.0, return_buffers: bool = False):
    """(dx, daln, dalb, dmt, the conditioner weights' gradients) for the
    cotangents g_xc and g_out of the step's (xc, out).

    A CUDA tensor launches ``csrc/flow_step_bwd.cu`` (the recomputed prefix
    and conditioner, the conditioner's transposed products, the prefix's
    transposed product, then one fixed-order reduction of every weight
    gradient: two calls are bitwise equal; the products in 3xTF32 on the
    tensor cores) and counts
    ``flow_step_backward.launches``; a CPU tensor runs
    ``flow_step_backward_reference``. ``return_buffers`` adds {"xin":
    [L, B, T, 2H]}: each conditioner layer's post-dropout conv output as the
    kernels recomputed it (the plain recompute's on the CPU).
    """
    B, T, C = x.shape
    half = C // 2
    if x.device.type == "cpu":
        out = flow_step_backward_reference(x, lens, aln, alb, mt, w, g_xc, g_out, seed, p_drop)
        if return_buffers:
            xc = _prefix(x, lens, aln, alb, mt)[2]
            return (*out, {"xin": torch.stack(_recompute(xc[..., :half], lens, w, seed, p_drop)[2])})
        return out
    if x.device.type != "cuda":
        raise ValueError(f"flow_step_backward: unsupported device {x.device}")
    _check_call(x, lens, aln, alb, mt, w, seed)
    for name, g in (("g_xc", g_xc), ("g_out", g_out)):
        if g.shape != (B, T, C) or g.dtype != torch.float32 or not g.is_contiguous() or g.device != x.device:
            raise ValueError(f"flow_step_backward: {name} must be a contiguous float32 [{B}, {T}, {C}] tensor")
    H, L = w.hidden, len(w.win)
    empty = lambda *shape: torch.empty(*shape, device=x.device, dtype=torch.float32)  # noqa: E731
    dx, daln, dalb, dmt = empty(B, T, C), empty(C), empty(C), empty(C, C)
    grads = WNWeights.from_flat([empty(*t.shape) for t in w.flat()], w.dilations)
    x1, xc, dx1, dxc = empty(B, T, C), empty(B, T, C), empty(B, T, C), empty(B, T, half)
    hs, acts, dh = empty(L, B, T, H), empty(L, B, T, H), empty(L, B, T, H)
    xin, dxin = empty(L, B, T, 2 * H), empty(L, B, T, 2 * H)
    skip, dskip = empty(B, T, H), empty(B, T, H)
    lib = _build.build()
    shape = _shape_args(x[..., :half], w)
    workspace = empty(lib.flow_step_bwd_workspace_floats(*shape))
    rc = lib.flow_step_bwd(
        x.data_ptr(), lens.data_ptr(), seed.data_ptr(), g_xc.data_ptr(), g_out.data_ptr(), aln.data_ptr(),
        alb.data_ptr(), mt.data_ptr(), w.ws.data_ptr(), _pointers(w.win), _pointers(w.wrs), w.wend.data_ptr(),
        w.bs.data_ptr(), _pointers(w.bin), _pointers(w.brs), dx.data_ptr(), daln.data_ptr(), dalb.data_ptr(),
        dmt.data_ptr(), grads.ws.data_ptr(), grads.bs.data_ptr(), _pointers(grads.win), _pointers(grads.bin),
        _pointers(grads.wrs), _pointers(grads.brs), grads.wend.data_ptr(), grads.bend.data_ptr(), x1.data_ptr(),
        xc.data_ptr(), dxc.data_ptr(), dx1.data_ptr(), hs.data_ptr(), xin.data_ptr(), acts.data_ptr(),
        skip.data_ptr(), dskip.data_ptr(), dh.data_ptr(), dxin.data_ptr(), workspace.data_ptr(), *shape,
        *_dropout_args(p_drop), _stream(x))
    if rc != 0:
        raise RuntimeError(f"flow_step_bwd launch failed with cudaError {rc}")
    flow_step_backward.launches += 1
    if return_buffers:
        return dx, daln, dalb, dmt, grads, {"xin": xin}
    return dx, daln, dalb, dmt, grads


class FlowStepFunction(torch.autograd.Function):
    """The flow step with a recompute backward: saves the inputs, the
    lengths, the seed and the weights, no activations."""

    @staticmethod
    def forward(ctx, x, lens, seed, p_drop, dilations, aln, alb, mt, *weights):  # pylint: disable=arguments-differ
        w = WNWeights.from_flat(weights, dilations)
        if x.device.type == "cpu":
            xc, out = flow_step_reference(x, lens, aln, alb, mt, w, seed, p_drop)
        else:
            xc, out = _launch_fwd(x, lens, aln, alb, mt, w, seed, p_drop)
        ctx.save_for_backward(x, lens, seed, aln, alb, mt, *weights)
        ctx.meta = (p_drop, dilations)
        return xc, out

    @staticmethod
    def backward(ctx, g_xc, g_out):  # pylint: disable=arguments-differ
        x, lens, seed, aln, alb, mt, *weights = ctx.saved_tensors
        p_drop, dilations = ctx.meta
        dx, daln, dalb, dmt, grads = flow_step_backward(
            x, lens, aln, alb, mt, WNWeights.from_flat(weights, dilations), g_xc.contiguous(), g_out.contiguous(),
            seed, p_drop)
        return (dx, None, None, None, None, daln, dalb, dmt, *grads.flat())


def flow_step(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor, mt: torch.Tensor,
              w: WNWeights, seed=None, p_drop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flow step; same contract as ``flow_step_reference``, differentiable
    in x, aln, alb, mt and every conditioner weight through
    ``FlowStepFunction``.

    A CUDA tensor launches ``csrc/flow_step_fwd.cu`` (x contiguous, lens
    int32 [B] and seed int64 [1] on the same device; every product in
    3xTF32 on the tensor cores) and counts
    ``flow_step.launches``; anything the kernels do not take raises. A CPU
    tensor runs the plain versions. Weights from the flow cache are for
    inference: a call with dropout raises, as ``wn_coupling`` does.
    """
    if w.cached and p_drop > 0.0:
        raise RuntimeError("flow_step: the flow cache's weights serve inference; clear_flow_cache before training")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flow_step: unsupported device {x.device}")
    keep_threshold(p_drop)
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int64, device=x.device)
    return FlowStepFunction.apply(x, lens, seed, float(p_drop), tuple(w.dilations), aln, alb, mt, *w.flat())


flow_step.launches = 0
flow_step_backward.launches = 0
