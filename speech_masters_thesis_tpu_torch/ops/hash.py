"""The 32-bit integer hash behind the kernels' dropout masks, in torch int64
ops (counterpart of ``csrc/hash.cuh``).

A u32 is held in an int64 (tensor or Python int); every result is reduced
mod 2^32, so the plain versions reproduce the kernels' bits exactly.
"""

from __future__ import annotations

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
