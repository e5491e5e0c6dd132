"""Numeric primitives (counterpart of speech_masters_thesis_tpu/ops/basic.py)."""

from __future__ import annotations

from typing import Optional

import torch

from speech_masters_thesis_tpu_torch.parallel import mesh


def safe_log(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """log(max(x, eps)); clamps to avoid -inf on silence/zero bins."""
    return torch.log(torch.clamp(x, min=eps))


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """fp32, or the input's dtype when it is wider (an fp64 reference step)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Rounds to bf16 (nearest even, as XLA's astype) and back to fp32: a
    product operand of the TPU kernels' bf16 mode. A product of two such
    values is exact in fp32, so an fp32 product of rounded operands is their
    bf16 x bf16 -> f32 dot up to the order of its sums."""
    return t.to(torch.bfloat16).to(torch.float32)


def same(t: torch.Tensor) -> torch.Tensor:
    """The fp32 mode's stand-in for ``round_bf16``: no rounding."""
    return t


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (not NaN/inf) gradient at x == 0 (double-where)."""
    positive = x > 0
    guarded = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(guarded), torch.zeros_like(x))


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[b] lengths -> [b, max_length] float32 mask (1 inside, 0 in padding)."""
    positions = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return (positions[None, :] < lengths[:, None]).to(torch.float32)


def pointwise(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv1d on [B, T, C] activations (weight [out, in, 1]) as one product."""
    return x @ w[:, :, 0].t() + b


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-token durations [b, t_x] -> hard monotonic 0/1 path [b, t_x, t_y]
    (``mask``'s shape): row i covers frames [cumdur[i-1], cumdur[i])."""
    t_y = mask.shape[2]
    cum_duration = torch.cumsum(duration, dim=1)
    frame = torch.arange(t_y, device=duration.device, dtype=cum_duration.dtype)
    upper = (frame[None, None, :] < cum_duration[:, :, None]).to(mask.dtype)
    lower = torch.nn.functional.pad(upper, (0, 0, 1, 0))[:, :-1]
    return (upper - lower) * mask


def softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """Last-axis softmax reduced in float32, returned in the input dtype (for
    float32 inputs exactly ``torch.softmax``)."""
    return torch.softmax(logits.to(torch.float32), dim=-1).to(logits.dtype)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``generator`` (on x's device)."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One kernel call's dropout seed, an int64 [1] tensor drawn on ``device``
    from ``generator`` (no host sync), mixed with the data-parallel rank
    (``parallel.mesh.mix_seed``)."""
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    return mesh.mix_seed(torch.randint(0, 2 ** 32, (1,), generator=generator, device=device, dtype=torch.int64))
