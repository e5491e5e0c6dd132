"""Small-T causal attention: plain PyTorch versions, the dropout masks and the
kernel wrappers (forward, recompute backward).

Counterpart of speech_masters_thesis_tpu/ops/pallas/attention.py
(``fused_attention`` and its custom VJP). The CUDA kernels are
``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``. For a CUDA tensor
``fused_attention`` runs ``FusedAttentionFunction``, whose forward and
backward launch them; for a CPU tensor it runs ``attention_reference``,
which CPU autograd differentiates. Nothing falls back: a CUDA tensor the
kernels do not take raises.

Semantics every version keeps (the JAX kernel's, ``attention.py:92-185``):
  * q, k, v, o are [B, T, H, D] (the JAX package's layout);
  * key c is valid for query row r when c <= r and c < lens[b]; masked
    logits are -1e9, not -inf; value rows at or past lens[b] are zeroed, so
    masked keys never reach O; query rows past lens[b] attend over the
    valid causal prefix and give finite values, which every consumer masks;
  * the softmax is fp32, and the backward uses
    ds = p * (dp - rowsum(dp * p)) * scale, with rowsum(dp * p) = rowsum(g * o);
  * dropout (``p_drop > 0``) keeps an element of P when its 32-bit draw is
    >= int(p * 2^32) and scales it by 1/(1-p). The draw is a pure function of
    (seed, sequence, head, query, key) (``ops/hash.py``), so kernel and plain
    version agree bit for bit on the masks and the backward regenerates them.
    The seed is an int64 [1] tensor on the inputs' device, so a seed drawn
    on the card never waits for the host.

Two modes, as the TPU kernel's ``dot_dtype`` (q's dtype) has them. fp32:
q, k, v and g float32, every product in 3xTF32 on the card. bf16 (the JAX
package's mixed-precision training; ``csrc/attention_bf16.cu``): q, k, v
and g bfloat16, each product's operands bf16 and its sums fp32, the masked
softmax fp32, P keep rounded to bf16 after normalisation (before P V and
dV), delta = rowsum(dp * p) in fp32 and dS rounded to bf16 before dQ and
dK; o, dq, dk and dv come out in bf16. Mixed dtypes raise.
``.launches`` counts fp32 kernel launches, ``.bf16_launches`` bf16 ones. A
bf16 CPU tensor runs ``FusedAttentionFunction`` over the plain versions,
whose backward rounds where the TPU kernel's does (autograd through the
rounded plain forward would round cotangents it does not); an fp32 CPU
tensor runs ``attention_reference`` under CPU autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from speech_masters_thesis_tpu_torch.ops import _build
from speech_masters_thesis_tpu_torch.ops.basic import at_least_f32, round_bf16, same
from speech_masters_thesis_tpu_torch.ops.hash import draw, keep_scale, keep_threshold, stream_key

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# dropout masks: the hash of csrc/attention_common.cuh in int64 torch ops
# ---------------------------------------------------------------------------
def dropout_bits(seed, batch: int, n_heads: int, T: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """[batch, n_heads, T, T] int64 holding the u32 draws of every (query,
    key) pair; ``seed`` an int or an int64 tensor of one element."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(device=device, dtype=torch.int64).reshape(())
    streams = torch.arange(batch * n_heads, dtype=torch.int64, device=device).view(batch, n_heads)
    keys = stream_key(seed, streams)[:, :, None, None]
    pos = torch.arange(T, dtype=torch.int64, device=device)
    return draw(keys, (pos[:, None] * T + pos[None, :])[None, None])


def keep_mask(seed, batch: int, n_heads: int, T: int, p_drop: float,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """[batch, n_heads, T, T] float32 of 0 or 1/(1-p)."""
    bits = dropout_bits(seed, batch, n_heads, T, device)
    return (bits >= keep_threshold(p_drop)).to(torch.float32) * keep_scale(p_drop)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def valid_pairs(lens: torch.Tensor, T: int) -> torch.Tensor:
    """[B, 1, T, T] bool: key c valid for query r (c <= r and c < lens[b])."""
    pos = torch.arange(T, device=lens.device)
    causal = pos[None, :] <= pos[:, None]
    return causal[None, None] & (pos[None, None, None, :] < lens.to(torch.int64)[:, None, None, None])


def _probs(q, k, lens, scale):
    """Masked fp32 softmax of (q k^T) * scale: [B, H, T, T]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(valid_pairs(lens, q.shape[1]), s, NEG_INF)
    return torch.softmax(s, dim=-1)


def _masked_values(v, lens):
    rows = torch.arange(v.shape[1], device=v.device)[None, :] < lens.to(torch.int64)[:, None]
    return v * rows[:, :, None, None].to(v.dtype)


def check_dtypes(*tensors: torch.Tensor) -> None:
    """q, k, v (and g) share one dtype, float32 or bfloat16 (or float64 for
    the plain versions): one mode per call."""
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16, torch.float64) or any(t.dtype != dtype for t in tensors):
        raise ValueError(f"fused_attention: q, k, v and g share one dtype (float32 or bfloat16); got "
                         f"{[t.dtype for t in tensors]}")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                        seed, scale: float, p_drop: float = 0.0) -> torch.Tensor:
    """Plain small-T attention: masked fp32 softmax, then dropout, then P V.

    q/k/v: [B, T, H, D]; lens: [B] int valid key lengths; ``seed`` (int or
    int64 tensor) picks the dropout masks when ``p_drop > 0``. Returns o
    [B, T, H, D] in q's dtype (bf16: P V of the dropped probabilities
    rounded to bf16, fp32 sums).
    """
    check_dtypes(q, k, v)
    B, T, H, _ = q.shape
    rnd = round_bf16 if q.dtype == torch.bfloat16 else same
    qf, kf, vf = (at_least_f32(t) for t in (q, k, v))
    p = _probs(qf, kf, lens, scale)
    if p_drop > 0.0:
        p = p * keep_mask(seed, B, H, T, p_drop, q.device)
    return torch.einsum("bhqk,bkhd->bqhd", rnd(p), _masked_values(vf, lens)).to(q.dtype)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 lens: torch.Tensor, seed, g: torch.Tensor, scale: float,
                                 p_drop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the recompute backward, by the kernels' formulas:
    (dq, dk, dv) for the output cotangent ``g``, in q's dtype. fp32:
    delta = rowsum(g o); bf16 (the TPU kernel's form): delta = rowsum(dp p)
    in fp32, P keep rounded before dV and dS before dQ and dK."""
    check_dtypes(q, k, v, g)
    dtype = q.dtype
    bf16 = dtype == torch.bfloat16
    rnd = round_bf16 if bf16 else same
    q, k, v, g = (at_least_f32(t) for t in (q, k, v, g))
    B, T, H, _ = q.shape
    with torch.no_grad():
        p = _probs(q, k, lens, scale)
        keep = keep_mask(seed, B, H, T, p_drop, q.device) if p_drop > 0.0 else None
        pd = p * keep if keep is not None else p
        vm = _masked_values(v, lens)
        dp = torch.einsum("bqhd,bkhd->bhqk", g, vm)
        if keep is not None:
            dp = dp * keep
        if bf16:
            delta = (dp * p).sum(dim=-1, keepdim=True)             # rowsum(dp p): [B, H, T, 1]
        else:
            o = torch.einsum("bhqk,bkhd->bqhd", pd, vm)
            delta = (g * o).sum(dim=-1).permute(0, 2, 1)[..., None]   # rowsum(g o): [B, H, T, 1]
        dv = _masked_values(torch.einsum("bhqk,bqhd->bkhd", rnd(pd), g), lens)
        ds = rnd(p * (dp - delta) * scale)
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_call(q, k, v, lens, seed, contiguous=()) -> int:
    """Raises on anything the kernels do not take; returns the row stride of
    q, k and v."""
    B, T, H, D = q.shape
    if torch.cuda.get_device_capability(q.device) != (9, 0):
        raise RuntimeError("fused_attention: the kernels are built for sm_90a (Hopper)")
    if D != _build.ATTENTION_HEAD_DIM:
        raise ValueError(f"fused_attention: kernels are built for D={_build.ATTENTION_HEAD_DIM}, got {D}")
    ld = q.stride(1) if T > 1 else q.stride(0)  # a dimension of size 1 may carry any stride
    check_dtypes(q, k, v)
    if q.dtype == torch.float64:
        raise ValueError("fused_attention: the kernels take float32 or bfloat16 tensors")
    per_row = 16 // q.element_size()  # elements of a 16-byte piece
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.device != q.device or t.shape != q.shape:
            raise ValueError(f"fused_attention: {name} must be {q.dtype} {tuple(q.shape)} on {q.device}")
        strides = t.stride() if T > 1 else (t.stride(0), ld, *t.stride()[2:])
        if strides != (T * ld, ld, D, 1) or ld % per_row or t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} must have strides (T*ld, ld, D, 1) with "
                             f"16-byte rows, as q has; got {t.stride()}")
    for name, t, dtype in contiguous:
        if t.dtype != dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"fused_attention: {name} must be a contiguous {dtype} tensor on {q.device}")
    if lens.dtype != torch.int32 or lens.shape != (B,) or lens.device != q.device or not lens.is_contiguous():
        raise ValueError("fused_attention: lens must be a contiguous int32 [B] tensor on the inputs' device")
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != q.device:
        raise ValueError("fused_attention: seed must be an int64 tensor of one element on the inputs' device")
    return ld


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _dropout_args(p_drop: float):
    return int(p_drop > 0.0), keep_threshold(p_drop), keep_scale(p_drop)


def _launch_fwd(q, k, v, lens, seed, scale: float, p_drop: float):
    ld = _check_call(q, k, v, lens, seed)
    B, T, H, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    o = torch.empty(B, T, H, D, device=q.device, dtype=q.dtype)
    stats = torch.empty(B, H, T, 2, device=q.device, dtype=torch.float32)
    lib = _build.build()
    rc = (lib.attention_fwd_bf16 if bf16 else lib.attention_fwd)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, lens.data_ptr(), seed.data_ptr(),
        o.data_ptr(), stats.data_ptr(), B, T, H, D, float(scale), *_dropout_args(p_drop), _stream(q))
    if rc != 0:
        raise RuntimeError(f"attention_fwd{'_bf16' if bf16 else ''} launch failed with cudaError {rc}")
    if bf16:
        fused_attention.bf16_launches += 1
    else:
        fused_attention.launches += 1
    return o, stats


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       stats: torch.Tensor, lens: torch.Tensor, seed, g: torch.Tensor, scale: float,
                       p_drop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the cotangent ``g``.

    A CUDA tensor launches the two kernels of ``csrc/attention_bwd.cu`` (bf16:
    ``csrc/attention_bf16.cu``, which takes no ``o``), which recompute P
    from q, k and the forward's row statistics ``stats`` ([B, H, T, 2]: max
    and sum) and regenerate its dropout masks; ``attention_backward.launches``
    (fp32) or ``.bf16_launches`` counts calls that launch them. A CPU
    tensor runs ``attention_backward_reference`` (``o`` and ``stats`` unused).
    """
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, lens, seed, g, scale, p_drop)
    if q.device.type != "cuda":
        raise ValueError(f"attention_backward: unsupported device {q.device}")
    bf16 = q.dtype == torch.bfloat16
    needs = ((("o", o, torch.float32),) if not bf16 else ()) + (("g", g, q.dtype), ("stats", stats, torch.float32))
    ld = _check_call(q, k, v, lens, seed, needs)
    B, T, H, D = q.shape
    if (not bf16 and o.shape != q.shape) or g.shape != q.shape or stats.shape != (B, H, T, 2):
        raise ValueError("attention_backward: o and g must be [B, T, H, D] and stats [B, H, T, 2]")
    dq, dk, dv = (torch.empty(B, T, H, D, device=q.device, dtype=q.dtype) for _ in range(3))
    delta = torch.empty(B, H, T, device=q.device, dtype=torch.float32)
    lib = _build.build()
    if bf16:
        rc = lib.attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, stats.data_ptr(), lens.data_ptr(), seed.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, T, H, D, float(scale),
            *_dropout_args(p_drop), _stream(q))
    else:
        rc = lib.attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, o.data_ptr(), stats.data_ptr(),
            lens.data_ptr(), seed.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), B, T, H, D, float(scale), *_dropout_args(p_drop), _stream(q))
    if rc != 0:
        raise RuntimeError(f"attention_bwd{'_bf16' if bf16 else ''} launch failed with cudaError {rc}")
    if bf16:
        attention_backward.bf16_launches += 1
    else:
        attention_backward.launches += 1
    return dq, dk, dv


class FusedAttentionFunction(torch.autograd.Function):
    """Attention with a recompute backward: on the card the forward kernel,
    and a backward that keeps q, k, v, lens, the seed, O and the row
    statistics and recomputes P in the backward kernels; on the CPU (the
    bf16 mode) the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, lens, seed, scale, p_drop):  # pylint: disable=arguments-differ
        if q.device.type == "cpu":
            o, stats = attention_reference(q, k, v, lens, seed, scale, p_drop), None
        else:
            o, stats = _launch_fwd(q, k, v, lens, seed, scale, p_drop)
        ctx.save_for_backward(q, k, v, o, stats, lens, seed)
        ctx.meta = (scale, p_drop)
        return o

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        q, k, v, o, stats, lens, seed = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, stats, lens, seed, g.to(q.dtype).contiguous(), *ctx.meta)
        return dq, dk, dv, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                    seed: torch.Tensor, scale: float, p_drop: float = 0.0) -> torch.Tensor:
    """Causal, key-length-masked attention; same contract as
    ``attention_reference``.

    A CUDA tensor runs ``FusedAttentionFunction`` (``csrc/attention_fwd.cu``,
    or ``csrc/attention_bf16.cu`` for bf16 tensors, differentiable through
    ``attention_backward``): q, k and v may be the [B, T, H, D] views of one
    packed projection (rows ``ld`` elements apart), lens is int32 [B] and
    seed int64 [1] on the same device, and anything else raises. An fp32
    CPU tensor runs the plain version, a bf16 one the Function over the
    plain versions. ``fused_attention.launches`` counts fp32 forward kernel
    launches, ``.bf16_launches`` bf16 ones.
    """
    check_dtypes(q, k, v)
    if q.device.type == "cpu" and q.dtype != torch.bfloat16:
        return attention_reference(q, k, v, lens, seed, scale, p_drop)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    keep_threshold(p_drop)
    return FusedAttentionFunction.apply(q, k, v, lens, seed, float(scale), float(p_drop))


# launches of the fp32 kernels and of the bf16 ones
fused_attention.launches = fused_attention.bf16_launches = 0
attention_backward.launches = attention_backward.bf16_launches = 0
