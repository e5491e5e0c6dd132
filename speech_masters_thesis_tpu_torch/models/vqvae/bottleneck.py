"""VQ bottleneck, inference side (counterpart of
speech_masters_thesis_tpu/models/vqvae/bottleneck.py).

Ported: quantize (fp32 distances, argmin), dequantize, ``encode``,
``decode`` and the eval ``forward`` (``update_k=False``) with the masked
commit loss and the ``fit``/``prenorm`` metrics. The codebook is the
buffer ``k``; ``k_sum`` and ``k_elem`` are non-persistent buffers, so the
``state_dict`` holds only ``k``, as a reference checkpoint does. The lazy
init and the EMA update with revival come with the training step.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.ops.basic import safe_sqrt


class BottleneckBlock(nn.Module):
    """Single-level k-means codebook over [B, T, C] encodings."""

    def __init__(self, k_bins: int, emb_width: int, mu: float, threshold: float):
        super().__init__()
        self.k_bins, self.emb_width, self.mu, self.threshold = k_bins, emb_width, mu, threshold
        self.register_buffer("k", torch.zeros(k_bins, emb_width))
        self.register_buffer("k_sum", torch.zeros(k_bins, emb_width), persistent=False)
        self.register_buffer("k_elem", torch.ones(k_bins), persistent=False)

    def _distances(self, x_flat: torch.Tensor) -> torch.Tensor:
        """Squared L2 distance table [N, K] = |x|^2 - 2 x k^T + |k|^2, in fp32."""
        x32 = x_flat.to(torch.float32)
        k32 = self.k.to(torch.float32)
        cross = x32 @ k32.t()
        return (torch.sum(x32 * x32, dim=-1, keepdim=True)
                - 2.0 * cross
                + torch.sum(k32 * k32, dim=-1)[None, :])

    def quantize(self, x_flat: torch.Tensor):
        distance = self._distances(x_flat)
        min_distance, codes = torch.min(distance, dim=-1)
        return codes, min_distance

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        return self.k[codes]

    def encode(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, T, C] + [B, T] -> codes [B, T]."""
        b, t, c = x.shape
        codes, _ = self.quantize(x.reshape(b * t, c))
        return codes.reshape(b, t)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """[B, T] int -> [B, T, C] embeddings."""
        return self.dequantize(codes)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, update_k: bool = False):
        """x: [B, T, C]; mask: [B, T]. Returns (codes, x_q, commit_loss, metrics)."""
        if update_k:
            raise NotImplementedError("the codebook update is not ported yet (inference only)")
        b, t, c = x.shape
        x_flat = x.reshape(b * t, c)
        m_flat = mask.reshape(b * t).to(torch.float32)
        codes, min_distance = self.quantize(x_flat)
        x_d = self.dequantize(codes)

        # reference quirk kept by the JAX package: fit is sum(min_distance)/k_bins
        # over ALL rows, padding included
        fit = torch.sum(min_distance) / self.k_bins
        x32 = x_flat.to(torch.float32)
        n_valid = torch.clamp(torch.sum(m_flat) * c, min=1.0)
        x_mean = torch.sum(x32 * m_flat[:, None]) / n_valid
        prenorm = safe_sqrt(torch.sum(((x32 - x_mean) * m_flat[:, None]) ** 2)) / safe_sqrt(n_valid)

        diff = (x_d.detach() - x32) * m_flat[:, None]
        commit_loss = torch.sum(diff * diff) / (torch.clamp(torch.sum(m_flat), min=1.0) * c)

        # straight-through value, computed as the JAX package does
        x_d = x_d.to(x_flat.dtype)
        x_q = x_flat + (x_d - x_flat).detach()
        x_q = (x_q * m_flat.to(x_q.dtype)[:, None]).reshape(b, t, c)
        return codes.reshape(b, t), x_q, commit_loss, {"fit": fit, "prenorm": prenorm}


class Bottleneck(nn.Module):
    """Per-level stack of BottleneckBlocks (``level_blocks.{l}``)."""

    def __init__(self, l_bins: int, emb_width: int, mu: float, levels: int, threshold: float):
        super().__init__()
        self.level_blocks = nn.ModuleList([
            BottleneckBlock(l_bins, emb_width, mu, threshold) for _ in range(levels)])

    def encode(self, xs, masks):
        return [blk.encode(x, m) for blk, x, m in zip(self.level_blocks, xs, masks)]

    def decode(self, zs):
        return [blk.decode(z) for blk, z in zip(self.level_blocks, zs)]

    def forward(self, xs, masks, update_k: bool = False):
        zs, xs_q, commit_losses, metrics = [], [], [], []
        for blk, x, m in zip(self.level_blocks, xs, masks):
            z, x_q, commit, metric = blk(x, m, update_k=update_k)
            zs.append(z)
            xs_q.append(x_q)
            commit_losses.append(commit)
            metrics.append(metric)
        return zs, xs_q, commit_losses, metrics
