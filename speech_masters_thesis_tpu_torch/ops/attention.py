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
"""

from __future__ import annotations

from typing import Tuple

import torch

from speech_masters_thesis_tpu_torch.ops import _build
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


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                        seed, scale: float, p_drop: float = 0.0) -> torch.Tensor:
    """Plain small-T attention: masked fp32 softmax, then dropout, then P V.

    q/k/v: [B, T, H, D]; lens: [B] int valid key lengths; ``seed`` (int or
    int64 tensor) picks the dropout masks when ``p_drop > 0``. Returns o
    [B, T, H, D].
    """
    B, T, H, _ = q.shape
    p = _probs(q, k, lens, scale)
    if p_drop > 0.0:
        p = p * keep_mask(seed, B, H, T, p_drop, q.device)
    return torch.einsum("bhqk,bkhd->bqhd", p, _masked_values(v, lens))


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 lens: torch.Tensor, seed, g: torch.Tensor, scale: float,
                                 p_drop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the recompute backward, by the kernels' formulas:
    (dq, dk, dv) for the output cotangent ``g``."""
    B, T, H, _ = q.shape
    with torch.no_grad():
        p = _probs(q, k, lens, scale)
        keep = keep_mask(seed, B, H, T, p_drop, q.device) if p_drop > 0.0 else None
        pd = p * keep if keep is not None else p
        vm = _masked_values(v, lens)
        o = torch.einsum("bhqk,bkhd->bqhd", pd, vm)
        delta = (g * o).sum(dim=-1).permute(0, 2, 1)[..., None]   # rowsum(g o): [B, H, T, 1]
        dv = _masked_values(torch.einsum("bhqk,bqhd->bkhd", pd, g), lens)
        dp = torch.einsum("bqhd,bkhd->bhqk", g, vm)
        if keep is not None:
            dp = dp * keep
        ds = p * (dp - delta) * scale
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return dq, dk, dv


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
    ld = q.stride(1)
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.dtype != torch.float32 or t.device != q.device or t.shape != q.shape:
            raise ValueError(f"fused_attention: {name} must be float32 {tuple(q.shape)} on {q.device}")
        if t.stride() != (T * ld, ld, D, 1) or ld % 4 or t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} must have strides (T*ld, ld, D, 1) with "
                             f"16-byte rows, as q has; got {t.stride()}")
    for name, t in contiguous:
        if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"fused_attention: {name} must be a contiguous float32 tensor on {q.device}")
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
    o = torch.empty(B, T, H, D, device=q.device, dtype=torch.float32)
    stats = torch.empty(B, H, T, 2, device=q.device, dtype=torch.float32)
    rc = _build.build().attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, lens.data_ptr(), seed.data_ptr(),
        o.data_ptr(), stats.data_ptr(), B, T, H, D, float(scale), *_dropout_args(p_drop), _stream(q))
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed with cudaError {rc}")
    fused_attention.launches += 1
    return o, stats


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       stats: torch.Tensor, lens: torch.Tensor, seed, g: torch.Tensor, scale: float,
                       p_drop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the cotangent ``g``.

    A CUDA tensor launches the two kernels of ``csrc/attention_bwd.cu``,
    which recompute P from q, k and the forward's row statistics ``stats``
    ([B, H, T, 2]: max and sum) and regenerate its dropout masks;
    ``attention_backward.launches`` counts calls that launch them. A CPU
    tensor runs ``attention_backward_reference`` (``o`` and ``stats`` unused).
    """
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, lens, seed, g, scale, p_drop)
    if q.device.type != "cuda":
        raise ValueError(f"attention_backward: unsupported device {q.device}")
    ld = _check_call(q, k, v, lens, seed, (("o", o), ("g", g), ("stats", stats)))
    B, T, H, D = q.shape
    if o.shape != q.shape or g.shape != q.shape or stats.shape != (B, H, T, 2):
        raise ValueError("attention_backward: o and g must be [B, T, H, D] and stats [B, H, T, 2]")
    dq, dk, dv = (torch.empty(B, T, H, D, device=q.device, dtype=torch.float32) for _ in range(3))
    delta = torch.empty(B, H, T, device=q.device, dtype=torch.float32)
    rc = _build.build().attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, o.data_ptr(), stats.data_ptr(),
        lens.data_ptr(), seed.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), B, T, H, D, float(scale), *_dropout_args(p_drop), _stream(q))
    if rc != 0:
        raise RuntimeError(f"attention_bwd launch failed with cudaError {rc}")
    attention_backward.launches += 1
    return dq, dk, dv


class FusedAttentionFunction(torch.autograd.Function):
    """Attention on the card: the forward kernel, and a backward that keeps
    q, k, v, lens, the seed, O and the row statistics and recomputes P in
    the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, lens, seed, scale, p_drop):  # pylint: disable=arguments-differ
        o, stats = _launch_fwd(q, k, v, lens, seed, scale, p_drop)
        ctx.save_for_backward(q, k, v, o, stats, lens, seed)
        ctx.meta = (scale, p_drop)
        return o

    @staticmethod
    def backward(ctx, g):  # pylint: disable=arguments-differ
        q, k, v, o, stats, lens, seed = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, stats, lens, seed, g.contiguous(), *ctx.meta)
        return dq, dk, dv, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor,
                    seed: torch.Tensor, scale: float, p_drop: float = 0.0) -> torch.Tensor:
    """Causal, key-length-masked attention; same contract as
    ``attention_reference``.

    A CUDA tensor runs ``FusedAttentionFunction`` (``csrc/attention_fwd.cu``,
    differentiable through ``attention_backward``): q, k and v may be the
    [B, T, H, D] views of one packed projection (rows ``ld`` floats apart),
    lens is int32 [B] and seed int64 [1] on the same device, and anything
    else raises. A CPU tensor runs the plain version.
    ``fused_attention.launches`` counts forward kernel launches.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, lens, seed, scale, p_drop)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    keep_threshold(p_drop)
    return FusedAttentionFunction.apply(q, k, v, lens, seed, float(scale), float(p_drop))


fused_attention.launches = 0
attention_backward.launches = 0
