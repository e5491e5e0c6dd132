"""Residual conv blocks of the VQ-VAE codec (counterpart of
speech_masters_thesis_tpu/models/vqvae/blocks.py), NTC layout.

``gated_hifi`` (the codec's) and ``base`` (``ResNetBlock``, VQ-TTS's quant
decoder) are ported; ``wavenet`` and ``hifi`` raise in ``get_block``.
Modules keep the reference torch ``state_dict`` layout (``blocks.{d}.0``,
``blocks.{d}.1.model.{2,5}``, ``gate``; ``model.{i}.model.{2,5}``). Dropout
runs in train mode only and draws from the ``torch.Generator`` the caller
passes: ``ResLayer`` (and so ``ResNetBlock``) draws its masks from it, on the
activations' device, ``GatedHiFiBlock`` one 32-bit seed per call for the
kernel's hashed masks (as the JAX block draws its seed from
``make_rng("dropout")``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from speech_masters_thesis_tpu_torch.ops.basic import dropout
from speech_masters_thesis_tpu_torch.ops.gated_hifi import gated_hifi, pack_weights
from speech_masters_thesis_tpu_torch.parallel import mesh


def get_mod_cycle(depth: int, cycle: Optional[int]) -> int:
    return depth if cycle is None else depth % cycle


def _zero_(conv: nn.Conv1d) -> None:
    """Zero-init (``zero_out``); ``zero_init`` tells the initializer to keep it."""
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    conv.zero_init = True


class ResLayer(nn.Module):
    """dropout -> relu -> dilated conv -> dropout -> relu -> 1x1 (zero-init),
    with residual.

    ``model`` is a Sequential so the parameter keys are ``model.2`` and
    ``model.5``, as in a reference checkpoint; its Dropout modules hold the
    rate.
    """

    def __init__(self, n_in: int, n_state: int, dilation: int = 1, kernel_size: int = 3,
                 zero_out: bool = True, res_scale: float = 1.0, dropout: float = 0.1):
        super().__init__()
        pad = ((kernel_size - 1) * dilation) // 2
        self.model = nn.Sequential(
            nn.Dropout(dropout),
            nn.ReLU(),
            nn.Conv1d(n_in, n_state, kernel_size, 1, pad, dilation),
            nn.Dropout(dropout),
            nn.ReLU(),
            nn.Conv1d(n_state, n_in, 1),
        )
        if zero_out:
            _zero_(self.model[-1])
        self.res_scale = res_scale

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, C] -> [B, T, C]; dropout (train only) from ``generator``."""
        p = self.model[0].p if train else 0.0
        h = dropout(x, p, generator) if p > 0 else x
        h = _conv(self.model[2], torch.relu(h).transpose(1, 2))
        if p > 0:
            h = dropout(h, p, generator)
        h = _conv(self.model[5], torch.relu(h)).transpose(1, 2)
        return x + self.res_scale * h


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``; an fp32 x against bf16 weights (VQ-TTS's quant decoder on
    the fp32 aligned text under bf16 training) runs in fp32, the weights
    promoted as JAX promotes them."""
    if conv.weight.dtype == x.dtype:
        return conv(x)
    dtype = torch.promote_types(conv.weight.dtype, x.dtype)
    return F.conv1d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), conv.stride, conv.padding,
                    conv.dilation)


class GatedHiFiBlock(nn.Module):
    """Parallel HiFi branches fused by softmax/tanh gating, run by ``ops.gated_hifi``.

    Returns the sequence-masked output ``(x*m + scale*v) * m`` on every
    device, so the convs downstream see the same values whichever version
    of the block ran.
    """

    def __init__(self, n_in: int, n_depth: int, dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None, kernel_size_growth_rate: int = 2,
                 kernel_size_cycle: Optional[int] = None, zero_out: bool = True,
                 res_scale: bool = False, p_dropout: float = 0.1):
        super().__init__()
        self.p_dropout = p_dropout
        self.res_scale = 1.0 if not res_scale else 1.0 / math.sqrt(n_depth)
        self.dilations = tuple(dilation_growth_rate ** get_mod_cycle(d, dilation_cycle)
                               for d in range(n_depth))
        kernels = [3 + kernel_size_growth_rate * get_mod_cycle(d, kernel_size_cycle)
                   for d in range(n_depth)]
        self.blocks = nn.ModuleList([
            nn.Sequential(
                nn.Conv1d(n_in, 2 * n_in, 1),
                ResLayer(2 * n_in, 2 * n_in, dilation=dil, kernel_size=k, zero_out=zero_out,
                         res_scale=self.res_scale, dropout=p_dropout),
            )
            for k, dil in zip(kernels, self.dilations)
        ])
        self.gate = nn.Conv1d(n_in, n_in, 1)
        if zero_out:
            _zero_(self.gate)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: [B, T, W]; mask: [B, T, 1] -> (out [B, T, W], mask).

        In train mode with ``p_dropout > 0`` one seed is drawn from
        ``generator`` (a CPU generator keeps the draw off the device). x and
        the parameters share one dtype, float32 or bfloat16 (the kernel's
        bf16 mode). The lengths are summed in the mask's dtype, as the JAX
        block sums them: a bf16 mask rounds a length above 256 that bf16
        cannot hold, and the kernel then takes the rounded length.
        """
        p = self.p_dropout if train else 0.0
        seed = 0
        if p > 0:
            if generator is None:
                raise ValueError("GatedHiFiBlock in train mode needs a dropout torch.Generator")
            seed = mesh.mix_seed(int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                                                   device=generator.device).item()))
        lens = mask[..., 0].sum(dim=1).to(torch.int32)
        weights = pack_weights(dict(self.named_parameters()), self.dilations)
        out = gated_hifi((x * mask).contiguous(), lens, weights, self.res_scale, p, seed)
        return out, mask


class ResNetBlock(nn.Module):
    """Serial stack of dilated ``ResLayer``s (``model.{i}``), plain PyTorch
    (the JAX block is flax, no kernel). Layer i has dilation
    ``dilation_growth_rate ** depth_i``, the depths reversed under
    ``reverse_dilation`` (layer 0 then has the largest); each layer sees
    ``x * mask``."""

    def __init__(self, n_in: int, n_depth: int, m_conv: float = 1.0, dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None, zero_out: bool = True, res_scale: bool = False,
                 reverse_dilation: bool = False, p_dropout: float = 0.1):
        super().__init__()
        scale = 1.0 if not res_scale else 1.0 / math.sqrt(n_depth)
        depths = list(range(n_depth))
        if reverse_dilation:
            depths = depths[::-1]
        self.model = nn.ModuleList([
            ResLayer(n_in, int(m_conv * n_in), dilation=dilation_growth_rate ** get_mod_cycle(d, dilation_cycle),
                     zero_out=zero_out, res_scale=scale, dropout=p_dropout)
            for d in depths])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: [B, T, C]; mask: [B, T, 1] or None -> (out [B, T, C], mask)."""
        m = 1.0 if mask is None else mask
        for layer in self.model:
            x = layer(x * m, train, generator)
        return x, mask


BLOCKS = {"gated_hifi": GatedHiFiBlock, "base": ResNetBlock}
NOT_PORTED = ("wavenet", "hifi")


def get_block(block_type: str):
    if block_type in NOT_PORTED:
        raise NotImplementedError(f"block_type={block_type} is not ported yet; gated_hifi and base are")
    if block_type not in BLOCKS:
        raise ValueError(f"Unknown block_type={block_type}; known: {sorted(BLOCKS)}")
    return BLOCKS[block_type]
