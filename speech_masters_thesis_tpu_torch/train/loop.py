"""Train and val steps (counterpart of speech_masters_thesis_tpu/train/loop.py,
``make_train_step``, ``make_val_step`` and ``NanLossError``).

One train step: forward in train mode (dropout, codebook init and EMA
update), backward, optional clip by global norm (over the parameters that
train: frozen ones have no gradient), the optimizer update with the
schedule's learning rate, and the parameter EMA. Randomness is explicit:
the step's seed and the step count give three generators, as the JAX step
folds the step into its key and splits it: ``dropout`` on the CPU (the
GatedHiFi blocks draw host-side seeds from it), ``codebook`` and
``device_dropout`` on the model's device (the LM draws its dropout masks and
its attention-dropout seeds there, so nothing waits for the host). The step
returns its scalars as device tensors with ``finite``; nothing syncs with
the host except a codebook's lazy-init check, on the first step that runs
it (``BottleneckBlock.init_seen``). The val step runs the model's
``supervised_step`` in eval mode with the EMA parameters, so it
evaluates any task, in fp32 (the JAX package's val step has no bf16).

``make_train_step(..., bf16=True)`` is the JAX step's mixed precision
(``_to_bf16``, train.py's ``--bf16``): the forward runs on a bf16 compute
copy of every float32 parameter and of every float32 tensor of the batch,
made inside the graph (``functional_call``), so the gradients land in the
float32 masters, on which the clip, the optimizer and the parameter EMA
run. Buffers (the VQ codebook, the LM's positional table) keep their dtype;
the model casts them where the JAX model does, reduces its losses in the
dtypes the JAX model does, and the loss is cast to fp32 for the backward
(JAX's ``loss_dict["loss"].astype(jnp.float32)``). Every model of the
package declares the mode (``BF16_TRAINING``: the VQ-VAE, the Transformer
LM, Glow-TTS on both decoder routes and VQ-TTS, each kernel of their train
paths in its bf16 mode); a model without it raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from speech_masters_thesis_tpu_torch.models.ema import ema_step, eval_params
from speech_masters_thesis_tpu_torch.train.optim import clip_by_global_norm
from speech_masters_thesis_tpu_torch.train.state import TrainState


class NanLossError(RuntimeError):
    pass


def step_generators(seed: int, step: int, device: torch.device) -> Dict[str, torch.Generator]:
    """The step's dropout (CPU), codebook and device dropout (``device``)
    generators, a pure function of (seed, step)."""
    dropout_seed, codebook_seed, device_seed = np.random.SeedSequence([seed, step]).generate_state(3)
    return {"dropout": torch.Generator().manual_seed(int(dropout_seed)),
            "codebook": torch.Generator(device=device).manual_seed(int(codebook_seed)),
            "device_dropout": torch.Generator(device=device).manual_seed(int(device_seed))}


def _to_bf16(t):
    """A float32 tensor's bfloat16 copy (differentiable); anything else as it is."""
    return t.to(torch.bfloat16) if torch.is_tensor(t) and t.dtype == torch.float32 else t


def make_train_step(schedule: Callable[[int], float], ema_mu: float, use_ema: bool,
                    grad_clip_norm: Optional[float] = None, bf16: bool = False) -> Callable:
    """Builds the train step: (state, batch, seed) -> scalars; updates ``state``.
    ``bf16``: the forward in bfloat16 over fp32 masters (module docstring)."""

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor], seed: int):
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        generators = step_generators(seed, state.step, device)
        for group in opt.param_groups:
            group["lr"] = schedule(state.step)
        opt.zero_grad(set_to_none=True)
        if bf16:
            if not getattr(model, "BF16_TRAINING", False):
                raise NotImplementedError(f"bf16 training of {type(model).__name__}: the model declares no bf16 "
                                          "mode (BF16_TRAINING), as the JAX package has none for it")
            compute = {f"model.{name}": _to_bf16(p) for name, p in model.named_parameters()}
            loss_dict, metrics = functional_call(
                _SupervisedStep(model), compute, ({k: _to_bf16(v) for k, v in batch.items()}, True),
                {"generators": generators})
        else:
            loss_dict, metrics = model.supervised_step(batch, train=True, generators=generators)
        loss_dict["loss"].to(torch.float32).backward()
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


class _SupervisedStep(nn.Module):
    """Runs ``model.supervised_step`` as a forward, so ``functional_call`` can
    swap the parameters in (parameter names gain the prefix ``model.``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Mapping[str, torch.Tensor], train: bool,  # pylint: disable=arguments-differ
                generators: Optional[Mapping[str, torch.Generator]] = None):
        return self.model.supervised_step(batch, train=train, generators=generators)


def make_val_step(use_ema: bool) -> Callable:
    """Builds the val step: (state, batch) -> (loss_dict, metrics): the
    model's ``supervised_step`` in eval mode, with the EMA parameters when
    tracking."""

    @torch.no_grad()
    def val_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        params = eval_params(state.params, state.ema_params, use_ema)
        return functional_call(_SupervisedStep(state.model),
                               {f"model.{name}": p for name, p in params.items()},
                               (batch,), {"train": False})

    return val_step


def raise_if_not_finite(scalars: Mapping[str, torch.Tensor], step: int) -> None:
    """Host check of a step's ``finite`` flag (a sync): raises NanLossError."""
    if not bool(scalars["finite"]):
        stats = {k: float(v) for k, v in scalars.items() if k != "finite"}
        raise NanLossError(f"Nan detected in loss near step {step}: {stats}")
