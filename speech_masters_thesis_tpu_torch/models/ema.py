"""Exponential moving average of parameters (counterpart of
speech_masters_thesis_tpu/models/ema.py).

The EMA is a dict of tensors keyed like ``named_parameters()``. ``ema_step``
updates it in place (the JAX version returns a new pytree; in place saves a
second copy of the parameters), and evaluating "with the EMA" means calling
the model with these tensors in place of its parameters
(``torch.func.functional_call``), with no swap.

``default_mu`` follows the reference: mu = 1 - batch_size * n_devices / 1000.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


def init_ema(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A detached copy of every parameter (the shadow never aliases them)."""
    return {name: p.detach().clone() for name, p in params.items()}


@torch.no_grad()
def ema_step(ema_params: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
             mu: float) -> Dict[str, torch.Tensor]:
    """ema <- ema * mu + (1 - mu) * params, in place; returns ``ema_params``."""
    for name, e in ema_params.items():
        e.mul_(mu).add_(params[name].detach(), alpha=1.0 - mu)
    return ema_params


def default_mu(batch_size: int, n_devices: int) -> float:
    return 1.0 - (batch_size * n_devices / 1000.0)


def eval_params(params: Mapping[str, torch.Tensor], ema_params: Optional[Mapping[str, torch.Tensor]],
                use_ema: bool) -> Mapping[str, torch.Tensor]:
    """Parameters to use for validation: the EMA shadow when tracking is on."""
    return ema_params if (use_ema and ema_params is not None) else params
