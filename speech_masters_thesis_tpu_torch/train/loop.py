"""Train and val steps and the epoch loops (counterpart of
speech_masters_thesis_tpu/train/loop.py: ``make_train_step``,
``make_val_step``, ``NanLossError``, ``train_epoch`` and ``val_epoch``).

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

``train_epoch`` keeps each step's scalars on the device and drains them
every ``log_every_n_steps`` steps with one host sync a window, checking
``finite`` on every drained step (``NanLossError``), and drains the trailing
window at the epoch's end; it cuts a checkpoint when the step crosses a
multiple of ``ckpt_every_n_steps`` and logs the epoch's steps/s and the
share of its time blocked on input. Ctrl-C (SIGINT) during the epoch is
held until the running step ends: the epoch then drains its window and
raises ``TrainingInterrupted``, which carries the steps taken, so the
checkpoint the CLI cuts on it is one whole state. ``val_epoch`` averages the val step's
scalars over the split's batches, the partial one included.

Data parallel (``parallel/mesh.py``): both epochs hand each rank its rows of
the loader's global batch; the train step adds the ranks' gradients after
the backward and before the clip, so the clip sees the global norm, and
returns the global scalars (each rank's losses are its shares of the global
batch's, added over the ranks; the metrics are global already). The
dropout and device-dropout generators are the rank's own, a pure function
of (seed, step, rank) and rank 0's those of a one-process run; the codebook
generator is the same on every rank. ``val_epoch`` gathers every rank's
``y`` and ``yh`` and rank 0 writes the artifacts.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from speech_masters_thesis_tpu_torch.models.ema import ema_step, eval_params
from speech_masters_thesis_tpu_torch.parallel import mesh
from speech_masters_thesis_tpu_torch.train.optim import clip_by_global_norm
from speech_masters_thesis_tpu_torch.train.state import TrainState


logger = logging.getLogger(__name__)


class NanLossError(RuntimeError):
    pass


class TrainingInterrupted(KeyboardInterrupt):
    """Ctrl-C during ``train_epoch``, raised between steps after the window
    is drained; ``global_step`` counts the steps taken."""

    def __init__(self, global_step: int):
        super().__init__(global_step)
        self.global_step = global_step


@contextlib.contextmanager
def _held_interrupt() -> Iterator[List[bool]]:
    """Holds SIGINT while the block runs: the handler only appends to the
    yielded list, which the loop reads between steps. Off the main thread,
    where no handler can be set, SIGINT is left as it is."""
    seen: List[bool] = []
    if threading.current_thread() is not threading.main_thread():
        yield seen
        return
    previous = signal.signal(signal.SIGINT, lambda *_: seen.append(True))
    try:
        yield seen
    finally:
        signal.signal(signal.SIGINT, previous)


def step_generators(seed: int, step: int, device: torch.device, rank: int = 0) -> Dict[str, torch.Generator]:
    """The step's dropout (CPU), codebook and device dropout (``device``)
    generators, a pure function of (seed, step) and, for the two dropout
    generators, of the data-parallel ``rank`` (rank 0 draws what a
    one-process run draws; the codebook generator is every rank's)."""
    dropout_seed, codebook_seed, device_seed = np.random.SeedSequence([seed, step]).generate_state(3)
    if rank:
        dropout_seed, _, device_seed = np.random.SeedSequence([seed, step, rank]).generate_state(3)
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
        generators = step_generators(seed, state.step, device, mesh.rank())
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
        mesh.all_reduce_grads(model.parameters())
        if grad_clip_norm:
            clip_by_global_norm([p.grad for p in model.parameters()], grad_clip_norm)
        opt.step()
        if use_ema:
            ema_step(state.ema_params, state.params, ema_mu)
        state.step += 1
        scalars = {k: v.detach() for k, v in loss_dict.items() if "loss" in k}
        scalars.update({k: v.detach() for k, v in metrics.items()})
        scalars = mesh.sum_losses(scalars)
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


def to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, Optional[torch.Tensor]]:
    """A loader's numpy batch as tensors on ``device``; elided features stay None."""
    return {k: None if v is None else torch.as_tensor(v).to(device) for k, v in batch.items()}


def _group(key: str) -> str:
    return "loss" if "loss" in key else "metrics"


def train_epoch(*, state: TrainState, global_step: int, epoch: int, config: Mapping, train_step: Callable,
                dataloader, seed: int, writer=None, save_ckpt: Optional[Callable] = None) -> Tuple[TrainState, int]:
    """One training epoch; logs the window's mean scalars every
    ``log_every_n_steps`` steps under ``loss/train_*`` and ``metrics/train_*``.
    Raises TrainingInterrupted on Ctrl-C, once the running step has ended."""
    train = config["train"]
    log_every, ckpt_every = int(train["log_every_n_steps"]), int(train["ckpt_every_n_steps"])
    device = next(state.model.parameters()).device
    pending = []  # each step's scalars, on the device until the window drains

    def drain(at_step: int) -> None:
        nonlocal pending
        if not pending:
            return
        keys = list(pending[0])
        host = torch.stack([torch.stack([s[k].reshape(()).to(torch.float64) for k in keys])
                            for s in pending]).cpu().numpy()  # the window's one sync
        window, pending = host.shape[0], []
        finite = keys.index("finite")
        for row in host:
            if not row[finite]:
                stats = {k: float(v) for k, v in zip(keys, row) if k != "finite"}
                logger.error("Loss stats at failure: %s", stats)
                raise NanLossError(f"Nan detected in loss near step {at_step}")
        if writer is not None:
            for k, v in zip(keys, host.sum(axis=0) / window):
                if k != "finite":
                    writer.add_scalar(f"{_group(k)}/train_{k}", float(v), at_step)

    epoch_start = time.perf_counter()
    data_wait, steps = 0.0, 0
    it = iter(dataloader)
    with _held_interrupt() as interrupted:
        while not interrupted:
            t0 = time.perf_counter()
            batch = next(it, None)
            data_wait += time.perf_counter() - t0
            if batch is None:
                break
            pending.append(train_step(state, to_device(mesh.shard_batch(batch), device), seed))
            prev_step, global_step, steps = global_step, global_step + 1, steps + 1
            if global_step // log_every > prev_step // log_every:
                drain(global_step)
            if save_ckpt is not None and global_step // ckpt_every > prev_step // ckpt_every:
                save_ckpt(state, global_step, epoch)
        drain(global_step)  # the trailing window: checked and logged too
    if interrupted:
        logger.info("Interrupted in epoch %d after step %d", epoch, global_step)
        raise TrainingInterrupted(global_step)

    elapsed = time.perf_counter() - epoch_start  # the drain above waited for the card
    if steps:
        logger.info("epoch %d: %d steps in %.1fs (%.2f steps/s end-to-end; %.1fs = %.0f%% blocked on input "
                    "pipeline)", epoch, steps, elapsed, steps / elapsed, data_wait,
                    100.0 * data_wait / max(elapsed, 1e-9))
    return state, global_step


def _pad_time(x: np.ndarray, length: int) -> np.ndarray:
    """Zero-pads axis 1 (samples of [B, T] audio, frames of [B, frames, n_mels] mel)."""
    return np.pad(x, [(0, 0), (0, length - x.shape[1])] + [(0, 0)] * (x.ndim - 2))


def val_epoch(*, state: TrainState, epoch: int, config: Mapping, val_step: Callable, dataloader, writer=None,
              artifact_fn: Optional[Callable] = None) -> Dict[str, float]:
    """One validation epoch: the mean of each scalar over the batches, logged
    under ``loss/val_*`` and ``metrics/val_*`` at ``epoch``; ``artifact_fn``
    gets the ground truth ``y`` and the prediction ``yh`` of every batch (on
    rank 0, every rank's rows)."""
    device = next(state.model.parameters()).device
    losses: Dict[str, float] = defaultdict(float)
    ys, yhs = [], []
    n_batches = max(len(dataloader), 1)
    for batch in dataloader:
        loss_dict, metrics = val_step(state, to_device(mesh.shard_batch(batch), device))
        scalars = mesh.sum_losses({k: v for k, v in loss_dict.items() if "loss" in k and v.ndim == 0})
        scalars.update({k: v for k, v in metrics.items() if torch.is_tensor(v) and v.ndim == 0})
        for k, v in scalars.items():
            losses[k] += float(v) / n_batches
        if loss_dict.get("y") is not None and loss_dict.get("yh") is not None:
            ys.append(mesh.gather_rows(loss_dict["y"]).float().cpu().numpy())
            yhs.append(mesh.gather_rows(loss_dict["yh"]).float().cpu().numpy())
    if writer is not None:
        for k, v in losses.items():
            writer.add_scalar(f"{_group(k)}/val_{k}", v, epoch)
    if artifact_fn is not None and ys and mesh.rank() == 0:
        max_y, max_yh = max(a.shape[1] for a in ys), max(a.shape[1] for a in yhs)
        artifact_fn(config, epoch, writer, np.concatenate([_pad_time(a, max_y) for a in ys]),
                    np.concatenate([_pad_time(a, max_yh) for a in yhs]))
    return dict(losses)
