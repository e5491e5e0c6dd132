"""EMA k-means VQ bottleneck (counterpart of
speech_masters_thesis_tpu/models/vqvae/bottleneck.py).

Quantize (fp32 distances, argmin), dequantize, ``encode``, ``decode`` and
the forward. In train mode (``update_k=True``) the forward runs the lazy
codebook init on the first batch, quantizes against the codebook as it
stands after init, then updates it by EMA with revival of dead codes, and
returns the quantizer metrics, in the JAX package's order. In eval mode it
blocks every gradient into the encoder. The codebook is the buffer ``k``;
``k_sum``, ``k_elem`` and ``initialized`` are non-persistent buffers, so the
``state_dict`` holds only ``k``, as a reference checkpoint does. Randomness
comes from the ``torch.Generator`` the caller passes, on the codebook's
device.

Under data parallelism (``parallel/mesh.py``) the codebook is the global
batch's: the EMA update adds ``k_sum_batch`` and ``k_elem_batch`` over the
ranks, the lazy init and the revivals draw from every rank's rows in
global-batch order with the caller's generator (the same on every rank),
the commitment loss divides by the global count of valid rows and the
metrics come from global sums, so every rank holds the codebook of the
1-process step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.ops.basic import safe_log, safe_sqrt
from speech_masters_thesis_tpu_torch.parallel import mesh


def sample_rows(generator: torch.Generator, x: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    """k rows of x drawn with replacement in proportion to ``weights``, plus
    N(0, (0.01/sqrt(C))^2) noise so duplicate draws stay apart (the JAX
    package's ``_sample_rows``: categorical over log(max(weights, 1e-30)))."""
    n, c = x.shape
    idx = torch.multinomial(torch.clamp(weights, min=1e-30), k, replacement=True, generator=generator)
    noise = torch.randn((k, c), generator=generator, device=x.device, dtype=x.dtype)
    return x[idx] + noise * (0.01 / math.sqrt(c))


class BottleneckBlock(nn.Module):
    """Single-level k-means codebook over [B, T, C] encodings."""

    def __init__(self, k_bins: int, emb_width: int, mu: float, threshold: float):
        super().__init__()
        self.k_bins, self.emb_width, self.mu, self.threshold = k_bins, emb_width, mu, threshold
        self.register_buffer("k", torch.zeros(k_bins, emb_width))
        self.register_buffer("k_sum", torch.zeros(k_bins, emb_width), persistent=False)
        self.register_buffer("k_elem", torch.ones(k_bins), persistent=False)
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool), persistent=False)
        # host copy of ``initialized`` once seen set: the lazy-init check reads the buffer (a sync
        # with the card) only until then
        self.init_seen = False

    def _distances(self, x_flat: torch.Tensor) -> torch.Tensor:
        """Squared L2 distance table [N, K] = |x|^2 - 2 x k^T + |k|^2, in fp32."""
        x32 = x_flat.to(torch.float32)
        k32 = self.k.to(torch.float32)
        cross = x32 @ k32.t()
        return (torch.sum(x32 * x32, dim=-1, keepdim=True)
                - 2.0 * cross
                + torch.sum(k32 * k32, dim=-1)[None, :])

    @torch.no_grad()
    def quantize(self, x_flat: torch.Tensor):
        """Codes and their squared distances; no gradient (argmin)."""
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor, update_k: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: [B, T, C]; mask: [B, T]. Returns (codes, x_q, commit_loss, metrics).

        ``update_k`` (train mode) needs ``generator`` for the init and revival
        draws and updates the codebook buffers in place.
        """
        b, t, c = x.shape
        x_flat = x.reshape(b * t, c)
        m_flat = mask.reshape(b * t).to(torch.float32)

        if update_k:
            if generator is None:
                raise ValueError("the codebook update needs a torch.Generator")
            self._maybe_init(x_flat, m_flat, generator)

        codes, min_distance = self.quantize(x_flat)
        x_d = self.dequantize(codes)

        metrics = {}
        if update_k:
            metrics = self._update_k(x_flat, m_flat, codes, generator)

        # reference quirk kept by the JAX package: fit is sum(min_distance)/k_bins
        # over ALL rows, padding included
        fit = mesh.global_sum(torch.sum(min_distance)) / self.k_bins
        x32 = x_flat.to(torch.float32)
        n_valid = torch.clamp(mesh.global_sum(torch.sum(m_flat)) * c, min=1.0)
        x_mean = mesh.global_sum(torch.sum(x32 * m_flat[:, None])) / n_valid
        prenorm = (safe_sqrt(mesh.global_sum(torch.sum(((x32 - x_mean) * m_flat[:, None]) ** 2)))
                   / safe_sqrt(n_valid))
        metrics = dict(fit=fit, prenorm=prenorm, **metrics)

        diff = (x_d.detach() - x32) * m_flat[:, None]
        commit_loss = torch.sum(diff * diff) / (torch.clamp(mesh.global_sum(torch.sum(m_flat)), min=1.0) * c)

        # straight-through value, computed as the JAX package does
        x_d = x_d.to(x_flat.dtype)
        x_q = x_flat + (x_d - x_flat).detach()
        if not update_k:
            # eval: no gradient reaches the encoder through x_q
            x_q = x_q.detach()
        x_q = (x_q * m_flat.to(x_q.dtype)[:, None]).reshape(b, t, c)
        return codes.reshape(b, t), x_q, commit_loss, metrics

    @torch.no_grad()
    def _maybe_init(self, x_flat: torch.Tensor, m_flat: torch.Tensor,
                    generator: torch.Generator) -> None:
        """Lazy data-dependent init from the first batch (reference init_k)."""
        if self.init_seen:
            return
        if not bool(self.initialized):
            k_init = sample_rows(generator, mesh.gather_rows(x_flat.to(torch.float32)), mesh.gather_rows(m_flat),
                                 self.k_bins)
            self.k.copy_(k_init)
            self.k_sum.copy_(k_init)
            self.k_elem.fill_(1.0)
            self.initialized.fill_(True)
        self.init_seen = True

    @torch.no_grad()
    def _update_k(self, x_flat: torch.Tensor, m_flat: torch.Tensor, codes: torch.Tensor,
                  generator: torch.Generator) -> dict:
        """EMA centroid update with dead-code revival (reference update_k)."""
        x32 = x_flat.detach().to(torch.float32)
        onehot = torch.zeros(x32.shape[0], self.k_bins, device=x32.device, dtype=torch.float32)
        onehot.scatter_(1, codes[:, None], 1.0)
        onehot = onehot * m_flat[:, None]
        k_sum_batch = mesh.global_sum(onehot.t() @ x32)            # [K, C]
        k_elem_batch = mesh.global_sum(torch.sum(onehot, dim=0))   # [K]

        k_rand = sample_rows(generator, mesh.gather_rows(x32), mesh.gather_rows(m_flat), self.k_bins)

        old_k = self.k.clone()
        k_sum = self.mu * self.k_sum + (1.0 - self.mu) * k_sum_batch
        k_elem = self.mu * self.k_elem + (1.0 - self.mu) * k_elem_batch
        usage = (k_elem[:, None] >= self.threshold).to(torch.float32)
        k = usage * (k_sum / torch.clamp(k_elem[:, None], min=1e-8)) + (1.0 - usage) * k_rand
        self.k.copy_(k)
        self.k_sum.copy_(k_sum)
        self.k_elem.copy_(k_elem)

        k_prob = k_elem_batch / torch.clamp(torch.sum(k_elem_batch), min=1e-8)
        entropy = -torch.sum(k_prob * safe_log(k_prob, eps=1e-8))
        used_curr = torch.sum(k_elem_batch >= self.threshold)
        dk = torch.linalg.norm(k - old_k) / math.sqrt(old_k.numel())
        return dict(entropy=entropy, used_curr=used_curr, usage=torch.sum(usage), dk=dk)


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

    def forward(self, xs, masks, update_k: bool = False, generator: Optional[torch.Generator] = None):
        zs, xs_q, commit_losses, metrics = [], [], [], []
        for blk, x, m in zip(self.level_blocks, xs, masks):
            z, x_q, commit, metric = blk(x, m, update_k=update_k, generator=generator)
            zs.append(z)
            xs_q.append(x_q)
            commit_losses.append(commit)
            if update_k:
                metrics.append(metric)
        return zs, xs_q, commit_losses, metrics
