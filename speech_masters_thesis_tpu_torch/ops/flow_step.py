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

Two modes, as the TPU kernel's ``dot_dtype`` (x's dtype) has them. fp32: x,
the weights and the cotangents float32, every product in 3xTF32. bf16 (the
JAX package's mixed-precision training, ``wn_coupling.py:314-386``): x, the
conditioner's weights and the cotangents bfloat16, while aln, alb and mt
stay float32 (the JAX decoder upcasts them from the bf16 parameters; mt is
built from the rounded weight); the ActNorm runs in fp32 on x upcast, the
prefix's products round x1, dxc and mt as their operands, the conditioner
rounds as B3's bf16 mode, xc, out and dx come out in bf16, daln, dalb and
dmt in fp32 and the conditioner's gradients in bf16 (fp32 sums cast once).
Mixed dtypes raise. ``.launches`` counts fp32 kernel launches,
``.bf16_launches`` bf16 ones; a bf16 CPU tensor runs ``FlowStepFunction``
over the plain versions.

The CUDA kernels are ``csrc/flow_step_fwd.cu`` and ``csrc/flow_step_bwd.cu``
(fp32), and for bf16 ``csrc/wn_coupling_bf16.cu`` (B3's bf16 engine with the
prefix's products; the forward is the backward's recompute, launch for
launch). ``flow_step`` runs ``FlowStepFunction``: for a CUDA tensor its
forward launches the forward kernel (one call: 3 + 2 * n_layers launches, and
one more packing the weights, for fp32 only for k > 1) and its
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
from speech_masters_thesis_tpu_torch.ops.basic import at_least_f32, round_bf16, same, sequence_mask
from speech_masters_thesis_tpu_torch.ops.hash import keep_threshold
from speech_masters_thesis_tpu_torch.ops.wn_coupling import (
    WNWeights,
    _check_call as _check_conditioner,
    _dropout_args,
    _pointers,
    _shape_args,
    _stream,
    bwd16_scratch,
    check_dtypes as check_conditioner_dtypes,
    fwd16_scratch,
    conditioner_backward,
    recomputed_buffers,
    wn_coupling_reference,
)


def check_dtypes(x: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor, mt: torch.Tensor, w: WNWeights,
                 *cotangents: torch.Tensor) -> None:
    """x, the conditioner's weights and the cotangents share one dtype; aln,
    alb and mt are at least fp32 (fp32 for a bf16 x, as the TPU kernel takes them)."""
    check_conditioner_dtypes(x, w)
    prefix = torch.promote_types(x.dtype, torch.float32)
    for name, t in (("aln", aln), ("alb", alb), ("mt", mt)):
        if t.dtype != prefix:
            raise ValueError(f"flow_step: {name} is {t.dtype} but must be {prefix} for a {x.dtype} x")
    for g in cotangents:
        if g.dtype != x.dtype:
            raise ValueError(f"flow_step: a cotangent is {g.dtype} but x is {x.dtype}")


def _prefix(x, lens, aln, alb, mt, rnd=same):
    """(valid [B, T, 1], x1, xc): the ActNorm and the dense InvConvNear, x
    at least fp32; ``rnd`` rounds the product's operands (bf16 mode)."""
    valid = sequence_mask(lens, x.shape[1]).to(x.dtype)[..., None]
    x1 = (alb + torch.exp(aln) * x) * valid
    return valid, x1, rnd(x1) @ rnd(mt)


def _round_of(x: torch.Tensor):
    return round_bf16 if x.dtype == torch.bfloat16 else same


def flow_step_reference(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor,
                        mt: torch.Tensor, w: WNWeights, seed=0,
                        p_drop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain flow step: x [B, T, C], lens [B] -> (xc, out), both [B, T, C]
    in x's dtype (bf16: the ActNorm fp32, xc from the rounded x1 and mt,
    and the conditioner's bf16 mode on xc's first half)."""
    check_dtypes(x, aln, alb, mt, w)
    xc = _prefix(at_least_f32(x), lens, aln, alb, mt, _round_of(x))[2].to(x.dtype)
    return xc, wn_coupling_reference(xc[..., :x.shape[2] // 2], lens, w, seed, p_drop)


def flow_step_backward_reference(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor,
                                 mt: torch.Tensor, w: WNWeights, g_xc: torch.Tensor, g_out: torch.Tensor, seed=0,
                                 p_drop: float = 0.0):
    """Plain recompute backward by the TPU kernel's formulas
    (``_bwd_flow_kernel``): (dx, daln, dalb, dmt, the conditioner weights'
    gradients) for the cotangents g_xc of xc and g_out of out. bf16: dxc =
    g_xc + dx0 in fp32, the products round x1, dxc and mt, daln and dalb are
    fp32 sums, dx is rounded to bf16 and the conditioner's gradients (fp32
    sums) once, daln, dalb and dmt stay fp32."""
    check_dtypes(x, aln, alb, mt, w, g_xc, g_out)
    half = x.shape[2] // 2
    dtype, rnd = x.dtype, _round_of(x)
    with torch.no_grad():
        xf = at_least_f32(x)
        valid, x1, xc = _prefix(xf, lens, aln, alb, mt, rnd)
        dx0, grads = conditioner_backward(xc[..., :half].to(dtype), lens, w, g_out, seed, p_drop)
        gxc = at_least_f32(g_xc) * valid
        dxc = torch.cat([gxc[..., :half] + dx0, gxc[..., half:]], dim=-1)
        dmt = torch.einsum("btc,btn->cn", rnd(x1), rnd(dxc))
        dx1 = rnd(dxc) @ rnd(mt).t()
        ex = torch.exp(aln)
        daln = (dx1 * ex * xf * valid).sum(dim=(0, 1))
        dalb = (dx1 * valid).sum(dim=(0, 1))
        dx = dx1 * ex * valid
    return dx.to(dtype), daln, dalb, dmt, WNWeights.from_flat([t.to(dtype) for t in grads.flat()], w.dilations)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_call(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor, mt: torch.Tensor,
                w: WNWeights, seed: torch.Tensor) -> None:
    B, T, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous() or C % 2 or w.wend.shape[0] != C:
        raise ValueError(f"flow_step: x must be a contiguous float32 or bfloat16 [B, T, C] tensor with C even and "
                         f"equal to the end conv's width; got {tuple(x.shape)}, {x.dtype}, end {tuple(w.wend.shape)}")
    check_dtypes(x, aln, alb, mt, w)
    for name, t, shape in (("aln", aln, (C,)), ("alb", alb, (C,)), ("mt", mt, (C, C))):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"flow_step: {name} must be a contiguous float32 {shape} tensor on {x.device}")
    _check_conditioner(x[..., :C // 2], lens, w, seed)


def _launch_fwd(x, lens, aln, alb, mt, w: WNWeights, seed, p_drop: float, return_buffers: bool = False):
    """(xc, out), or with ``return_buffers`` (bf16 only) (xc, out, the
    conditioner's {"xin", "skip"} as ``flow_step_backward`` returns the
    recompute's)."""
    _check_call(x, lens, aln, alb, mt, w, seed)
    B, T, C = x.shape
    H = w.hidden
    bf16 = x.dtype == torch.bfloat16
    if return_buffers and not bf16:
        raise ValueError("flow_step: return_buffers reads back the bf16 forward's buffers only")
    xc, out = (torch.empty(B, T, C, device=x.device, dtype=x.dtype) for _ in range(2))
    lib = _build.build()
    shape = _shape_args(x[..., :C // 2], w)
    inputs = (x.data_ptr(), lens.data_ptr(), seed.data_ptr(), aln.data_ptr(), alb.data_ptr(), mt.data_ptr(),
              w.ws.data_ptr(), w.bs.data_ptr(), _pointers(w.win), _pointers(w.bin), _pointers(w.wrs),
              _pointers(w.brs), w.wend.data_ptr(), w.bend.data_ptr(), xc.data_ptr(), out.data_ptr())
    if bf16:
        scratch, parts, bufs = fwd16_scratch(x, shape, flow=True, buffers=return_buffers)
        rc = lib.flow_step_fwd_bf16(*inputs, parts, *shape, *_dropout_args(p_drop), _stream(x))
    else:
        h, acts, skip = (torch.empty(B, T, H, device=x.device, dtype=torch.float32) for _ in range(3))
        workspace = torch.empty(lib.flow_step_fwd_workspace_floats(*shape), device=x.device, dtype=torch.float32)
        rc = lib.flow_step_fwd(*inputs, h.data_ptr(), acts.data_ptr(), skip.data_ptr(), workspace.data_ptr(),
                               *shape, *_dropout_args(p_drop), _stream(x))
    if rc != 0:
        raise RuntimeError(f"flow_step_fwd{'_bf16' if bf16 else ''} launch failed with cudaError {rc}")
    if bf16:
        flow_step.bf16_launches += 1
    else:
        flow_step.launches += 1
    return (xc, out, bufs) if return_buffers else (xc, out)


def flow_step_backward(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor,
                       mt: torch.Tensor, w: WNWeights, g_xc: torch.Tensor, g_out: torch.Tensor, seed,
                       p_drop: float = 0.0, return_buffers: bool = False):
    """(dx, daln, dalb, dmt, the conditioner weights' gradients) for the
    cotangents g_xc and g_out of the step's (xc, out).

    A CUDA tensor launches ``csrc/flow_step_bwd.cu`` (the recomputed prefix
    and conditioner, the conditioner's transposed products, the prefix's
    transposed product, then one fixed-order reduction of every weight
    gradient: two calls are bitwise equal; the products in 3xTF32 on the
    tensor cores), or for bf16 tensors ``csrc/wn_coupling_bf16.cu``
    (B3's bf16 engine with the prefix's products, on TMA and wgmma) and counts
    ``flow_step_backward.launches`` (fp32) or ``.bf16_launches``; a CPU
    tensor runs ``flow_step_backward_reference``. ``return_buffers`` adds
    {"xin": [L, B, T, 2H], "skip": [B, T, H]}: each conditioner layer's
    post-dropout conv output and the skip sum as the kernels recomputed them
    (the plain recompute's on the CPU), fp32; in bf16 ``flow_step``'s
    ``return_buffers`` bit for bit; and "x0" [B, T, half]: the conditioner's
    input, xc's first half as the recompute formed it.
    """
    B, T, C = x.shape
    half = C // 2
    if x.device.type == "cpu":
        out = flow_step_backward_reference(x, lens, aln, alb, mt, w, g_xc, g_out, seed, p_drop)
        if return_buffers:
            x0 = flow_step_reference(x, lens, aln, alb, mt, w, seed, p_drop)[0][..., :half]
            return (*out, {**recomputed_buffers(x0, lens, w, seed, p_drop), "x0": x0})
        return out
    if x.device.type != "cuda":
        raise ValueError(f"flow_step_backward: unsupported device {x.device}")
    _check_call(x, lens, aln, alb, mt, w, seed)
    for name, g in (("g_xc", g_xc), ("g_out", g_out)):
        if g.shape != (B, T, C) or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
            raise ValueError(f"flow_step_backward: {name} must be a contiguous {x.dtype} [{B}, {T}, {C}] tensor")
    H, L = w.hidden, len(w.win)
    bf16 = x.dtype == torch.bfloat16
    empty = lambda *shape: torch.empty(*shape, device=x.device, dtype=torch.float32)  # noqa: E731
    dx = torch.empty(B, T, C, device=x.device, dtype=x.dtype)
    daln, dalb, dmt = empty(C), empty(C), empty(C, C)
    lib = _build.build()
    shape = _shape_args(x[..., :half], w)
    inputs = (x.data_ptr(), lens.data_ptr(), seed.data_ptr(), g_xc.data_ptr(), g_out.data_ptr(), aln.data_ptr(),
              alb.data_ptr(), mt.data_ptr(), w.ws.data_ptr(), _pointers(w.win), _pointers(w.wrs), w.wend.data_ptr(),
              w.bs.data_ptr(), _pointers(w.bin), _pointers(w.brs), dx.data_ptr(), daln.data_ptr(), dalb.data_ptr(),
              dmt.data_ptr())
    grads = WNWeights.from_flat([torch.empty_like(t) for t in w.flat()], w.dilations)
    if bf16:
        scratch, parts, bufs = bwd16_scratch(x, shape, flow=True)
        rc = lib.flow_step_bwd_bf16(
            *inputs, grads.ws.data_ptr(), grads.bs.data_ptr(), _pointers(grads.win), _pointers(grads.bin),
            _pointers(grads.wrs), _pointers(grads.brs), grads.wend.data_ptr(), grads.bend.data_ptr(), parts, *shape,
            *_dropout_args(p_drop), _stream(x))
    else:
        x1, dx1, dxc = empty(B, T, C), empty(B, T, C), empty(B, T, half)
        xc = torch.empty(B, T, C, device=x.device, dtype=x.dtype)
        hs, acts, dh = empty(L, B, T, H), empty(L, B, T, H), empty(L, B, T, H)
        xin, dxin = empty(L, B, T, 2 * H), empty(L, B, T, 2 * H)
        skip, dskip = empty(B, T, H), empty(B, T, H)
        workspace = empty(lib.flow_step_bwd_workspace_floats(*shape))
        bufs = {"xin": xin, "skip": skip, "x0": xc[..., :half]}
        rc = lib.flow_step_bwd(
            *inputs, grads.ws.data_ptr(), grads.bs.data_ptr(), _pointers(grads.win), _pointers(grads.bin),
            _pointers(grads.wrs), _pointers(grads.brs), grads.wend.data_ptr(), grads.bend.data_ptr(),
            *(t.data_ptr() for t in (x1, xc, dxc, dx1)), hs.data_ptr(), xin.data_ptr(), acts.data_ptr(),
            skip.data_ptr(), dskip.data_ptr(), dh.data_ptr(), dxin.data_ptr(), workspace.data_ptr(), *shape,
            *_dropout_args(p_drop), _stream(x))
    if rc != 0:
        raise RuntimeError(f"flow_step_bwd{'_bf16' if bf16 else ''} launch failed with cudaError {rc}")
    if bf16:
        flow_step_backward.bf16_launches += 1
    else:
        flow_step_backward.launches += 1
    if return_buffers:
        return dx, daln, dalb, dmt, grads, bufs
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
            x, lens, aln, alb, mt, WNWeights.from_flat(weights, dilations), g_xc.to(x.dtype).contiguous(),
            g_out.to(x.dtype).contiguous(), seed, p_drop)
        return (dx, None, None, None, None, daln, dalb, dmt, *grads.flat())


def flow_step(x: torch.Tensor, lens: torch.Tensor, aln: torch.Tensor, alb: torch.Tensor, mt: torch.Tensor,
              w: WNWeights, seed=None, p_drop: float = 0.0, return_buffers: bool = False):
    """The flow step; same contract as ``flow_step_reference``, differentiable
    in x, aln, alb, mt and every conditioner weight through
    ``FlowStepFunction``.

    A CUDA tensor launches ``csrc/flow_step_fwd.cu`` (x contiguous, lens
    int32 [B] and seed int64 [1] on the same device; every product in
    3xTF32 on the tensor cores), or for a bf16 x ``csrc/wn_coupling_bf16.cu``
    (TMA and wgmma, the bf16 backward's recompute launches), and counts
    ``flow_step.launches`` (fp32) or ``flow_step.bf16_launches``; anything
    the kernels do not take raises. A CPU tensor runs the plain versions.
    Weights from the flow cache are for inference: a call with dropout
    raises, as ``wn_coupling`` does. ``return_buffers`` (for tests; bf16 on
    the card, outside autograd) returns (xc, out, {"xin", "skip"}): the
    conditioner's post-dropout conv outputs and skip sum as
    ``flow_step_backward`` returns the recompute's (the plain recompute's on
    the CPU).
    """
    if w.cached and p_drop > 0.0:
        raise RuntimeError("flow_step: the flow cache's weights serve inference; clear_flow_cache before training")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flow_step: unsupported device {x.device}")
    keep_threshold(p_drop)
    check_dtypes(x, aln, alb, mt, w)
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int64, device=x.device)
    if return_buffers:
        with torch.no_grad():
            if x.device.type == "cpu":
                xc, out = flow_step_reference(x, lens, aln, alb, mt, w, seed, p_drop)
                return xc, out, recomputed_buffers(xc[..., :x.shape[2] // 2], lens, w, seed, p_drop)
            return _launch_fwd(x, lens, aln, alb, mt, w, seed, p_drop, return_buffers=True)
    return FlowStepFunction.apply(x, lens, seed, float(p_drop), tuple(w.dilations), aln, alb, mt, *w.flat())


# launches of the fp32 kernels and of the bf16 ones
flow_step.launches = flow_step.bf16_launches = 0
flow_step_backward.launches = flow_step_backward.bf16_launches = 0
