"""Train state (counterpart of speech_masters_thesis_tpu/train/state.py).

The JAX package threads one immutable pytree through its jitted step. Here
the state is an object the step updates in place: the step count, the model
(its parameters, and the codebook state as the buffers ``k``, ``k_sum``,
``k_elem``, ``initialized`` of its ``BottleneckBlock``s: the VQ-VAE's
bottleneck, the LM's frozen ``vqvae_bottleneck`` or VQ-TTS's grouped
``quant_bottleneck``), the optimizer with its
state, and the EMA parameters (of every parameter, frozen ones included, as
in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn as nn

from speech_masters_thesis_tpu_torch.models.ema import init_ema
from speech_masters_thesis_tpu_torch.models.vqvae.bottleneck import BottleneckBlock


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               use_ema: bool = False) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, model=model, optimizer=optimizer,
                   ema_params=init_ema(params) if use_ema else None)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def codebook(self) -> Dict[str, torch.Tensor]:
        """The codebook state by buffer name (``bottleneck.level_blocks.0.k``,
        ``vqvae_bottleneck.k`` for the LM, ``quant_bottleneck.k`` for VQ-TTS, ...)."""
        return {f"{prefix}.{name}": b
                for prefix, module in self.model.named_modules() if isinstance(module, BottleneckBlock)
                for name, b in module.named_buffers()}
