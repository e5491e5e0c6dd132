"""VQ-VAE reconstruction losses and the Transformer LM's losses (counterpart
of speech_masters_thesis_tpu/ops/losses.py).

Layouts are NTC: waveforms [B, T], masks [B, T], spectra [B, frames, bins].
The LM losses take flattened logits [N, C] and reduce in float32.

Under data parallelism (``parallel/mesh.py``) each rank returns its share of
the global batch's loss, so the ranks' shares add up to it: a mean over
rows enters as ``local_share`` (every rank holds as many rows) and a masked
mean divides by the mask's sum over every rank (``global_sum``). Outside a
process group both are the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops.basic import safe_log, safe_sqrt
from speech_masters_thesis_tpu_torch.parallel import mesh
from speech_masters_thesis_tpu_torch.ops.stft import STFT


def downsample_mask(mask: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[B, T] sample mask -> STFT frame rate.

    Pads left with ones and right with zeros by (n_fft-hop)//2, then strides
    at hop from n_fft//2: frames whose window centre falls in padding drop.
    """
    pad = (n_fft - hop_length) // 2
    m = F.pad(mask, (pad, 0), value=1.0)
    m = F.pad(m, (0, pad), value=0.0)
    start = n_fft // 2
    stop = m.shape[1] - n_fft // 2 + 1
    return m[:, start:stop:hop_length]


class MultiResolutionSpectralLoss:
    """Masked multi-resolution STFT magnitude loss.

    Per resolution: sqrt of the per-sample sum of squared magnitude errors,
    averaged over the batch; optionally the same on log magnitudes.
    """

    def __init__(self, n_ffts: Sequence[int], hop_lengths: Sequence[int],
                 win_lengths: Sequence[int] | None = None, window: str = "hann",
                 log: bool = False):
        wins = win_lengths if win_lengths is not None else n_ffts
        assert len(n_ffts) == len(hop_lengths) == len(wins)
        self.stfts = [STFT(n, h, w, window_type=window)
                      for n, h, w in zip(n_ffts, hop_lengths, wins)]
        self.log = log

    def __call__(self, y: torch.Tensor, yh: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """y, yh: [B, T] waveforms; mask: [B, T]."""
        loss = 0.0
        for stft in self.stfts:
            y_mag = stft(y)
            yh_mag = stft(yh)
            frame_mask = downsample_mask(mask, stft.n_fft, stft.hop_length)[:, :, None]
            diff = (y_mag - yh_mag) * frame_mask
            loss = loss + torch.mean(safe_sqrt(torch.sum(diff * diff, dim=(1, 2))))
            if self.log:
                log_diff = (safe_log(y_mag) - safe_log(yh_mag)) * frame_mask
                loss = loss + torch.mean(safe_sqrt(torch.sum(log_diff * log_diff, dim=(1, 2))))
        return mesh.local_share(loss / len(self.stfts))


class MultiNormReconstructionLoss:
    """Weighted L1 + L2 + top-k Linf loss over masked waveforms.

    The Linf term keeps the k largest squared errors per sample with an
    EXACT top-k. ``linf_approx: true`` selected a TPU-only approximate top-k
    in the JAX package; the port maps it to the exact top-k, which is the
    reference's semantics.
    """

    def __init__(self, l1: float = 0.0, l2: float = 1.0, linf: float = 0.02,
                 linf_topk: int = 2048, linf_approx: bool = False):
        del linf_approx  # exact top-k either way (see class docstring)
        self.l1, self.l2, self.linf, self.linf_topk = l1, l2, linf, linf_topk

    def __call__(self, y: torch.Tensor, yh: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = (y * mask).reshape(y.shape[0], -1).to(torch.float32)
        yh = (yh * mask).reshape(yh.shape[0], -1).to(torch.float32)
        diff = y - yh
        sq = diff * diff
        loss = self.l1 * torch.mean(torch.abs(diff)) + self.l2 * torch.mean(sq)
        if self.linf > 0:
            k = min(self.linf_topk, sq.shape[-1])
            topk_vals = torch.topk(sq, k, dim=-1).values
            loss = loss + self.linf * torch.sum(torch.mean(topk_vals, dim=0))
        return mesh.local_share(loss)


# ---------------------------------------------------------------------------
# Transformer LM losses: logits [N, C], targets [N] int, mask [N]
# ---------------------------------------------------------------------------
def _target_log_prob(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, 1, targets.to(torch.int64)[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over rows."""
    return mesh.local_share(-torch.mean(_target_log_prob(logits, targets)))


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """CE averaged over the rows the mask selects."""
    nll = -_target_log_prob(logits, targets)
    return torch.sum(nll * mask) / torch.clamp(mesh.global_sum(torch.sum(mask)), min=1.0)


def mmi_loss(logits: torch.Tensor, targets: torch.Tensor, num_classes: int,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Maximum-mutual-information loss: H(z|x) upper bound minus H(z).

    Keeps the reference's log_softmax of the one-hot target (a quirk that
    scales the CE-like term by a constant), as the JAX package does on
    purpose. A target outside [0, num_classes) has an all-zero one-hot row,
    as jax.nn.one_hot gives.
    """
    p_zy = torch.softmax(logits.to(torch.float32), dim=-1)
    classes = torch.arange(num_classes, device=targets.device)
    one_hot = (targets[:, None] == classes[None, :]).to(logits.dtype)
    row = -torch.sum(p_zy * torch.log_softmax(one_hot, dim=-1), dim=-1)
    if mesh.world_size() > 1:
        return _mmi_global(p_zy, row, mask)
    if mask is not None:
        p_z = torch.sum(p_zy * mask[:, None], dim=0) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        p_z = torch.mean(p_zy, dim=0)
    h_z = -torch.sum(p_z * torch.log(p_z))
    if mask is not None:
        h_z_x_ub = torch.sum(row * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        h_z_x_ub = torch.mean(row)
    return h_z_x_ub - h_z


def _mmi_global(p_zy: torch.Tensor, row: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """This rank's share of the global batch's MMI loss. H(z) is a function of
    the global p(z): every rank computes its value, with the gradient of its
    own rows, and the value enters the ranks' sum once."""
    weights = torch.ones_like(row) if mask is None else mask
    count = torch.clamp(mesh.global_sum(torch.sum(weights)), min=1.0)
    p_z = mesh.global_sum_through(torch.sum(p_zy * weights[:, None], dim=0)) / count
    h_z = -torch.sum(p_z * torch.log(p_z))
    h_z = h_z.detach() / mesh.world_size() + (h_z - h_z.detach())
    return torch.sum(row * weights) / count - h_z


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 0.0,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Focal loss (1 - p_t)^gamma * CE, mean over rows (or the masked rows)."""
    log_pt = _target_log_prob(logits, targets)
    per_row = (1.0 - torch.exp(log_pt)) ** gamma * -log_pt
    if mask is not None:
        return torch.sum(per_row * mask) / torch.clamp(mesh.global_sum(torch.sum(mask)), min=1.0)
    return mesh.local_share(torch.mean(per_row))
