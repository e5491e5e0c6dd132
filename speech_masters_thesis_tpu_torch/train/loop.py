"""Train and val steps (counterpart of speech_masters_thesis_tpu/train/loop.py,
``make_train_step``, ``make_val_step`` and ``NanLossError``).

One train step: forward in train mode (dropout, codebook init and EMA
update), backward, optional clip by global norm, the optimizer update with
the schedule's learning rate, and the parameter EMA. Randomness is
explicit: the step's seed and the step count give two generators, one for
dropout (on the CPU: the GatedHiFi blocks draw host-side seeds from it) and
one for the codebook (on the model's device), as the JAX step folds the
step into its key and splits it. The step returns its scalars as device
tensors with ``finite``; nothing syncs with the host except the codebook's
lazy-init check. fp32 only: the JAX step's bf16 path needs a bf16 kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from speech_masters_thesis_tpu_torch.models.ema import ema_step, eval_params
from speech_masters_thesis_tpu_torch.train.optim import clip_by_global_norm
from speech_masters_thesis_tpu_torch.train.state import TrainState


class NanLossError(RuntimeError):
    pass


def step_generators(seed: int, step: int, device: torch.device) -> Dict[str, torch.Generator]:
    """The step's dropout (CPU) and codebook (``device``) generators, a pure
    function of (seed, step)."""
    dropout_seed, codebook_seed = np.random.SeedSequence([seed, step]).generate_state(2)
    dropout = torch.Generator().manual_seed(int(dropout_seed))
    codebook = torch.Generator(device=device).manual_seed(int(codebook_seed))
    return {"dropout": dropout, "codebook": codebook}


def make_train_step(schedule: Callable[[int], float], ema_mu: float, use_ema: bool,
                    grad_clip_norm: Optional[float] = None) -> Callable:
    """Builds the train step: (state, batch, seed) -> scalars; updates ``state``."""

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor], seed: int):
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        generators = step_generators(seed, state.step, device)
        for group in opt.param_groups:
            group["lr"] = schedule(state.step)
        opt.zero_grad(set_to_none=True)
        loss_dict, metrics = model.supervised_step(batch, train=True, generators=generators)
        loss_dict["loss"].backward()
        if grad_clip_norm:
            clip_by_global_norm([p.grad for p in model.parameters()], grad_clip_norm)
        opt.step()
        if use_ema:
            ema_step(state.ema_params, state.params, ema_mu)
        state.step += 1
        scalars = {k: v.detach() for k, v in loss_dict.items() if "loss" in k}
        scalars.update({k: v.detach() for k, v in metrics.items()})
        scalars["finite"] = torch.isfinite(scalars["loss"])
        return scalars

    return train_step


def make_val_step(use_ema: bool) -> Callable:
    """Builds the val step: (state, batch) -> (loss_dict, metrics), with the
    EMA parameters when tracking."""

    @torch.no_grad()
    def val_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        params = eval_params(state.params, state.ema_params, use_ema)
        loss_dict, metrics = functional_call(
            state.model, dict(params), (batch["audio"], batch["audio_len"]),
            {"speaker": batch.get("speaker"), "train": False})
        loss_dict["y"] = batch["audio"]
        return loss_dict, metrics

    return val_step


def raise_if_not_finite(scalars: Mapping[str, torch.Tensor], step: int) -> None:
    """Host check of a step's ``finite`` flag (a sync): raises NanLossError."""
    if not bool(scalars["finite"]):
        stats = {k: float(v) for k, v in scalars.items() if k != "finite"}
        raise NanLossError(f"Nan detected in loss near step {step}: {stats}")
