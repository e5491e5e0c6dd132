"""Grouped (per-phoneme) VQ bottleneck of VQ-TTS (counterpart of
speech_masters_thesis_tpu/models/vqtts/bottleneck.py).

The codebook holds ``n_vocab * l_bins`` centroids, ``l_bins`` a phoneme.
Each audio frame takes the id of the token the hard alignment gives it and
is quantized against that token's group only: a [N, l_bins] distance table
from the frame's gathered [l_bins, C] centroids, one batched product, and
the codebook's squared norms, taken once a forward and gathered alike. The
relative code goes to the absolute index ``id * l_bins + q_rel`` for the
lookup and the EMA update, which (with the lazy init and dead-code revival)
is the base ``BottleneckBlock``'s, global over the data-parallel ranks as
there, as are the commitment loss's count and ``fit``. Unlike the base block's eval forward, the
straight-through value passes the encoder's gradient in both modes, as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from speech_masters_thesis_tpu_torch.models.vqvae.bottleneck import BottleneckBlock
from speech_masters_thesis_tpu_torch.ops.basic import at_least_f32
from speech_masters_thesis_tpu_torch.parallel import mesh


class GroupedBottleneck(BottleneckBlock):
    """``k_bins = n_vocab * l_bins``; each frame quantized within its aligned phoneme's group."""

    def __init__(self, k_bins: int, emb_width: int, mu: float, threshold: float, n_vocab: int, l_bins: int):
        super().__init__(k_bins, emb_width, mu, threshold)
        self.n_vocab, self.l_bins = n_vocab, l_bins

    def forward(self, y_enc: torch.Tensor, x_id: torch.Tensor, attn: torch.Tensor,  # pylint: disable=arguments-differ
                update_k: bool = False, generator: Optional[torch.Generator] = None):
        """y_enc [B, T_y, C] audio encodings, x_id [B, T_x] token ids, attn
        [B, T_x, T_y] hard alignment -> (q_rel [B, T_y], y_d [B, T_y, C],
        commit_loss, metrics). ``update_k`` (train mode) needs ``generator``
        (on the codebook's device) for the lazy init and the revival draws."""
        b, t_y, c = y_enc.shape
        m_flat = attn.sum(dim=1).reshape(b * t_y).to(torch.float32)   # frames the alignment covers
        x_id_frames = torch.einsum("btY,bt->bY", attn, x_id.to(attn.dtype))
        x_id_flat = x_id_frames.reshape(b * t_y).to(torch.int64)
        y_flat = y_enc.reshape(b * t_y, c)

        if update_k:
            if generator is None:
                raise ValueError("the codebook update needs a torch.Generator")
            self._maybe_init(y_flat, m_flat, generator)

        with torch.no_grad():
            y32 = at_least_f32(y_flat.detach())
            k32 = at_least_f32(self.k)
            k_frame = k32.view(self.n_vocab, self.l_bins, c)[x_id_flat]            # [N, l_bins, C]
            k_norm = torch.sum(k32 * k32, dim=-1).view(self.n_vocab, self.l_bins)[x_id_flat]
            cross = torch.bmm(k_frame, y32[:, :, None])[..., 0]                     # [N, l_bins]
            distance = torch.sum(y32 * y32, dim=-1, keepdim=True) - 2.0 * cross + k_norm
            min_distance, q_rel = torch.min(distance, dim=-1)                       # first index on ties
            q_abs = x_id_flat * self.l_bins + q_rel
            y_d = self.k[q_abs]                                                     # before the update

        metrics = {}
        if update_k:
            metrics = self._update_k(y_flat, m_flat, q_abs, generator)

        # reference quirk kept by the JAX package: fit is sum(min_distance) / l_bins over all rows
        fit = mesh.global_sum(torch.sum(min_distance)) / self.l_bins
        metrics = dict(fit=fit, **metrics)

        diff = (y_d - at_least_f32(y_flat)) * m_flat[:, None]
        commit_loss = torch.sum(diff * diff) / (torch.clamp(mesh.global_sum(torch.sum(m_flat)), min=1.0) * c)

        y_d = y_d.to(y_flat.dtype)
        y_d = y_flat + (y_d - y_flat).detach()
        y_d = (y_d * m_flat.to(y_d.dtype)[:, None]).reshape(b, t_y, c)
        return q_rel.reshape(b, t_y), y_d, commit_loss, metrics
