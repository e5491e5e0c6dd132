"""VQ-VAE conv encoder/decoder (counterpart of
speech_masters_thesis_tpu/models/vqvae/encdec.py), NTC at every interface.

Masked strided convs subsample the mask along with the signal
(``mask[:, ::stride]``); the transposed convs repeat it. Strided convs use
filter 2*stride and pad stride//2, so lengths divide exactly. The convs are
``F.conv1d``/``F.conv_transpose1d`` over the NCW view; parameter keys follow
the reference checkpoint (``level_blocks.{l}.blocks.{i}``, ``out``).
Single level only (``all_levels=False``). ``train`` and the dropout
``generator`` reach the residual blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.models.vqvae.blocks import get_block


def _codec_block(block_type: str):
    """The codec's residual block class. Only ``gated_hifi`` is wired here:
    a ``base`` codec block would also need ``m_conv`` and the decoder's
    ``reverse_decoder_dilation``, which no shipped config uses."""
    Block = get_block(block_type)
    if block_type != "gated_hifi":
        raise NotImplementedError(f"the codec's block_type={block_type} is not ported; only gated_hifi is")
    return Block


def _run(mods: nn.ModuleList, x: torch.Tensor, mask: torch.Tensor, train: bool,
         generator: Optional[torch.Generator]):
    """The convs take (x, mask); the residual blocks also the train flag and
    the dropout generator."""
    for mod in mods:
        if isinstance(mod, (MaskedConv1d, MaskedConvTranspose1d)):
            x, mask = mod(x, mask)
        else:
            x, mask = mod(x, mask, train=train, generator=generator)
    return x, mask


class MaskedConv1d(nn.Conv1d):
    """Conv over the masked input; the mask is stride-subsampled."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor):  # pylint: disable=arguments-differ
        """x: [B, T, C]; mask: [B, T, 1] -> ([B, T', F], [B, T', 1])."""
        y = super().forward((x * mask).transpose(1, 2)).transpose(1, 2)
        return y, mask[:, ::self.stride[0]]


class MaskedConvTranspose1d(nn.ConvTranspose1d):
    """Transposed conv over the masked input (torch geometry); the mask is repeated."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor):  # pylint: disable=arguments-differ
        y = super().forward((x * mask).transpose(1, 2)).transpose(1, 2)
        return y, mask.repeat_interleave(self.stride[0], dim=1)


class EncoderConvBlock(nn.Module):
    """down_t x (strided masked conv + residual block), then a 3x1 out conv."""

    def __init__(self, input_emb_width: int, output_emb_width: int, down_t: int,
                 stride_t: int, block_type: str, width: int, depth: int, **block_kwargs):
        super().__init__()
        Block = _codec_block(block_type)
        mods = []
        if down_t > 0:
            filt, pad = stride_t * 2, stride_t // 2
            for i in range(down_t):
                mods.append(MaskedConv1d(input_emb_width if i == 0 else width,
                                         width, filt, stride_t, pad))
                mods.append(Block(width, depth, **block_kwargs))
            mods.append(MaskedConv1d(width, output_emb_width, 3, 1, 1))
        self.blocks = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return _run(self.blocks, x, mask, train, generator)


class DecoderConvBlock(nn.Module):
    """3x1 in conv, then down_t x (residual block + strided masked transposed conv)."""

    def __init__(self, input_emb_width: int, output_emb_width: int, down_t: int,
                 stride_t: int, block_type: str, width: int, depth: int, **block_kwargs):
        super().__init__()
        Block = _codec_block(block_type)
        mods = []
        if down_t > 0:
            filt, pad = stride_t * 2, stride_t // 2
            mods.append(MaskedConv1d(output_emb_width, width, 3, 1, 1))
            for i in range(down_t):
                mods.append(Block(width, depth, **block_kwargs))
                mods.append(MaskedConvTranspose1d(
                    width, input_emb_width if i == down_t - 1 else width, filt, stride_t, pad))
        self.blocks = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return _run(self.blocks, x, mask, train, generator)


class Encoder(nn.Module):
    """Level L output is downsampled prod(stride**down) x; [B, T, C] in and out.

    ``block_kwargs`` go to every residual block (dilation/kernel growth, zero_out).
    """

    def __init__(self, input_emb_width: int, output_emb_width: int, downs_t: Sequence[int],
                 strides_t: Sequence[int], block_type: str, width: int, depth: int,
                 **block_kwargs):
        super().__init__()
        self.level_blocks = nn.ModuleList([
            EncoderConvBlock(input_emb_width if level == 0 else output_emb_width,
                             output_emb_width, down_t, stride_t, block_type, width, depth,
                             **block_kwargs)
            for level, (down_t, stride_t) in enumerate(zip(downs_t, strides_t))
        ])

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: [B, T, input_emb_width]; mask: [B, T, 1] -> ([B, T', C], [B, T', 1])."""
        for block in self.level_blocks:
            x, mask = block(x, mask, train, generator)
        return x, mask


class Decoder(nn.Module):
    """Mirrored decoder over the levels in reverse, then a 1x1 ``out`` conv."""

    def __init__(self, input_emb_width: int, output_emb_width: int, downs_t: Sequence[int],
                 strides_t: Sequence[int], block_type: str, width: int, depth: int,
                 **block_kwargs):
        super().__init__()
        self.level_blocks = nn.ModuleList([
            DecoderConvBlock(output_emb_width, output_emb_width, down_t, stride_t,
                             block_type, width, depth, **block_kwargs)
            for down_t, stride_t in zip(downs_t, strides_t)
        ])
        self.out = nn.Conv1d(output_emb_width, input_emb_width, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: [B, T', C]; mask: [B, T', 1] -> ([B, T, input_emb_width], [B, T, 1])."""
        for block in reversed(self.level_blocks):
            x, mask = block(x, mask, train, generator)
        y = self.out((x * mask).transpose(1, 2)).transpose(1, 2)
        return y, mask
