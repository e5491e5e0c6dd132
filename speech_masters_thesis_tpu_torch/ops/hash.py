"""The 32-bit integer hash behind the kernels' dropout masks, in torch int64
ops (counterpart of ``csrc/hash.cuh``).

A u32 is held in an int64 (tensor or Python int); every result is reduced
mod 2^32, so the plain versions reproduce the kernels' bits exactly.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # 2^32 / golden ratio: spaces the per-stream keys


def mul32(a, c: int):
    """a * c mod 2^32 for a u32 held in int64 (tensor or int): c split in 16-bit
    halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & U32


def fmix32(h):
    """MurmurHash3's 32-bit finalizer on a u32 held in int64."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def stream_key(seed, stream):
    """The u32 key of stream ``stream`` (int or int64 tensor, >= 0) under
    ``seed``: fmix32(fmix32(seed) + (stream + 1) * GOLDEN)."""
    return fmix32((fmix32(seed & U32) + mul32(stream + 1, GOLDEN)) & U32)


def draw(key, counter):
    """One u32 draw per counter: fmix32(fmix32(key ^ counter) + key)."""
    return fmix32((fmix32(key ^ (counter & U32)) + key) & U32)


def keep_threshold(p_drop: float) -> int:
    """A 32-bit draw keeps its element when it is >= this u32 (as the TPU
    kernels' ``int(p * 2**32)``)."""
    if not 0.0 <= p_drop < 1.0:
        raise ValueError(f"p_drop must be in [0, 1), got {p_drop}")
    return int(p_drop * 2 ** 32)


def keep_scale(p_drop: float) -> float:
    """The float32 factor a kept element is multiplied by."""
    return float(np.float32(1.0 / (1.0 - p_drop)))


def keep_factor(seed, stream, counter, p_drop: float, dtype=torch.float32) -> torch.Tensor:
    """0 or 1/(1-p) per element: kept when ``draw(stream_key(seed, stream),
    counter) >= keep_threshold(p_drop)``. ``seed`` is an int or an int64
    tensor of one element; ``stream`` and ``counter`` int64 tensors that
    broadcast together."""
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64).reshape(())
    bits = draw(stream_key(seed, stream), counter)
    return (bits >= keep_threshold(p_drop)).to(dtype) * keep_scale(p_drop)
