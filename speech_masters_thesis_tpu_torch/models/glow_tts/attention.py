"""Glow-TTS text-encoder submodules: LayerNorm over channels, the prenet,
windowed relative self-attention, the conv FFN and the duration predictor
(counterpart of speech_masters_thesis_tpu/models/glow_tts/attention.py).

Activations are [B, T, C]; parameters keep the reference checkpoint's names
and PyTorch's Conv1d layout, so ``state_dict`` keys are those of
``tools/import_torch_checkpoint.py:export_glow_tts``. The attention and
FFN modules hold the weights of an encoder layer; the layer itself runs as
one call of ``ops/enc_layer.py`` (the fused kernel or its plain version),
which also holds the math used here and the layer's own dropout sites. The
prenet's and the duration predictor's dropout masks are drawn on the
activations' device from a ``torch.Generator`` (no host sync).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.ops.basic import dropout
from speech_masters_thesis_tpu_torch.ops.enc_layer import conv1d_ntc, layer_norm


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels, eps 1e-4, flax's statistics (``gamma``, ``beta``)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # pylint: disable=arguments-differ
        return layer_norm(x, self.gamma, self.beta, self.eps)


class ConvReluNorm(nn.Module):
    """Prenet: n x (conv -> LayerNorm -> relu -> dropout), then x + proj(...),
    masked; ``proj`` starts at zero. Its dropout is ``P_DROPOUT`` in train
    mode, whatever the encoder's (the JAX encoder fixes it)."""

    P_DROPOUT = 0.1

    def __init__(self, hidden_channels: int, out_channels: int, kernel_size: int, n_layers: int):
        super().__init__()
        if n_layers <= 1:
            raise ValueError("ConvReluNorm needs more than one layer")
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(hidden_channels, hidden_channels, kernel_size) for _ in range(n_layers))
        self.norm_layers = nn.ModuleList(ChannelLayerNorm(hidden_channels) for _ in range(n_layers))
        self.proj = nn.Conv1d(hidden_channels, out_channels, 1)
        self.proj.zero_init = True

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:  # pylint: disable=arguments-differ
        x_org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = torch.relu(norm(conv1d_ntc(x * mask, conv.weight, conv.bias)))
            if train and self.P_DROPOUT > 0:
                x = dropout(x, self.P_DROPOUT, generator)
        return (x_org + conv1d_ntc(x, self.proj.weight, self.proj.bias)) * mask


class RelativeSelfAttention(nn.Module):
    """The weights of self-attention with windowed relative position tables
    shared by the heads (``emb_rel_k``, ``emb_rel_v`` [1, 2w+1, D]), 1x1 convs
    ``conv_q/k/v/o``. What the TextEncoder uses; ``block_length``,
    ``proximal_bias``, per-head tables and no window are not ported."""

    def __init__(self, channels: int, out_channels: int, n_heads: int, window_size=None,
                 heads_share: bool = True, block_length=None, proximal_bias: bool = False):
        super().__init__()
        if window_size is None or not heads_share or block_length is not None or proximal_bias:
            raise NotImplementedError("RelativeSelfAttention: only a window with shared-head tables is "
                                      "ported (no block_length, proximal_bias or per-head tables)")
        self.n_heads = n_heads
        self.window_size = window_size
        d = channels // n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window_size + 1, d))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window_size + 1, d))


class FeedForwardNetwork(nn.Module):
    """The k-wide conv FFN's weights, ``conv_1`` and ``conv_2``."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int, kernel_size: int):
        super().__init__()
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size)


class DurationPredictor(nn.Module):
    """Per-token log-durations: 2 x (conv -> relu -> LayerNorm -> dropout),
    then a 1x1 to one channel."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int):
        super().__init__()
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size)
        self.norm_1 = ChannelLayerNorm(filter_channels)
        self.conv_2 = nn.Conv1d(filter_channels, filter_channels, kernel_size)
        self.norm_2 = ChannelLayerNorm(filter_channels)
        self.proj = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, p_drop: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:  # pylint: disable=arguments-differ
        """x [B, T, C], mask [B, T, 1] -> [B, T]; dropout ``p_drop`` (train mode)."""
        h = self.norm_1(torch.relu(conv1d_ntc(x * mask, self.conv_1.weight, self.conv_1.bias)))
        if p_drop > 0.0:
            h = dropout(h, p_drop, generator)
        h = self.norm_2(torch.relu(conv1d_ntc(h * mask, self.conv_2.weight, self.conv_2.bias)))
        if p_drop > 0.0:
            h = dropout(h, p_drop, generator)
        return (conv1d_ntc(h * mask, self.proj.weight, self.proj.bias) * mask)[..., 0]
