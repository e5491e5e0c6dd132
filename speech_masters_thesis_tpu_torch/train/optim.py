"""Optimizers and LR schedules (counterpart of
speech_masters_thesis_tpu/train/optim.py, which builds them with optax).

Schedules map the optimizer's update count (0 for the first update) to a
learning rate and use step+1, the reference's ``last_epoch + 1``
convention. ``adam`` is ``torch.optim.AdamW``, which has optax ``adamw``'s
update (eps outside the square root, decoupled weight decay scaled by the
learning rate); ``sgd`` is ``torch.optim.SGD`` with its weight decay added to
the gradient before momentum, as ``add_decayed_weights`` then ``sgd`` do.
The train step sets the learning rate from the schedule before every
update. ``clip_by_global_norm`` follows optax: grads * max / norm when
norm >= max, without ``clip_grad_norm_``'s 1e-6.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional, Tuple

import torch


def dummy_schedule(base_lr: float) -> Callable[[int], float]:
    return lambda count: base_lr


def linear_warmup_schedule(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    return lambda count: base_lr * min((count + 1) / warmup_steps, 1.0)


def noam_schedule(base_lr: float, dim_model: int, warmup_steps: int) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        step = float(count + 1)
        return base_lr * dim_model ** (-0.5) * min(step ** (-0.5), step * warmup_steps ** (-1.5))
    return schedule


def cosine_schedule(base_lr: float, total_steps: int, eta_min: float = 0.0) -> Callable[[int], float]:
    return lambda count: eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * (count + 1) / total_steps)) / 2


def build_schedule(optimizer_cfg: Mapping, scheduler_cfg: Optional[Mapping] = None,
                   model_cfg: Optional[Mapping] = None, train_cfg: Optional[Mapping] = None
                   ) -> Callable[[int], float]:
    """The schedule a config's ``optimizer``/``scheduler`` sections name."""
    base_lr = optimizer_cfg["lr"]
    if not scheduler_cfg:
        return dummy_schedule(base_lr)
    name = scheduler_cfg["name"]
    if name == "noam":
        model_cfg = model_cfg or {}
        dim_model = model_cfg.get("d_model") or model_cfg["encoder"]["hidden_channels"]
        return noam_schedule(base_lr, dim_model, scheduler_cfg["warmup_steps"])
    if name == "linear":
        return linear_warmup_schedule(base_lr, scheduler_cfg["warmup_steps"])
    if name == "cosine":
        total_steps = scheduler_cfg.get("total_steps") or (train_cfg or {}).get("total_steps")
        if not total_steps:
            raise ValueError("scheduler: cosine requires `scheduler.total_steps` (or "
                             "`train.total_steps`), the annealing horizon T_max")
        return cosine_schedule(base_lr, int(total_steps))
    raise ValueError(f"Didn't recognize scheduler name {name}")


def build_optimizer(params: Iterable[torch.nn.Parameter], optimizer_cfg: Mapping,
                    scheduler_cfg: Optional[Mapping] = None, model_cfg: Optional[Mapping] = None,
                    train_cfg: Optional[Mapping] = None
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """Returns (optimizer, schedule); the step sets ``lr`` from the schedule."""
    schedule = build_schedule(optimizer_cfg, scheduler_cfg, model_cfg, train_cfg)
    name = optimizer_cfg["name"]
    if name == "adam":
        opt = torch.optim.AdamW(params, lr=schedule(0), betas=tuple(optimizer_cfg["betas"]),
                                eps=float(optimizer_cfg["eps"]),
                                weight_decay=float(optimizer_cfg["weight_decay"]))
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=schedule(0), momentum=optimizer_cfg.get("momentum") or 0.0,
                              weight_decay=float(optimizer_cfg.get("weight_decay") or 0.0))
    else:
        raise ValueError(f"Didn't recognize optimizer name {name}")
    return opt, schedule


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scales ``grads`` in place by max_norm / norm where norm >= max_norm;
    returns the global norm (no host sync)."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm
